// Fused three-source gather + per-segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gather_aggregate/kernel.py::
// gather_aggregate_pallas (body _gather_agg_kernel), called by
// TieredFeatureStore.lookup_aggregate.
//
//   out[s] = Σ_{n = 0..fan-1} row(tier[s,n], slot[s,n])
//   row(0, k) = hot[clamp(k)], row(1, k) = warm[clamp(k)],
//   row(2, k) = cold[clamp(k)], any other tier contributes 0.
//
// The sum is taken in fp32, sequentially over n = 0, 1, ..., fan-1, then
// cast to the table dtype. That order is the contract of the Pallas kernel
// and of the plain version (kernels/gather_aggregate/ref.py), so kernel ==
// plain bitwise, and the fused serve path == the unfused one.
//
// Bound on an H100: HBM bytes. Per call it must read 8 bytes of tier/slot
// per child, each valid child row once and write each output row once:
// 8·S·fan + valid_children·d·elem + S·d·elem bytes at 3.35 TB/s; the
// valid_children·d fp32 adds are far below the compute peak.
// Design against that bound: a block of (cols x segs) threads, one thread
// per column and segs segments per block. Each thread walks its segment's
// children in order with one fp32 register accumulator, so the dense
// (S·fan, d) child tensor is never written to memory; the tier/slot of a
// child are a broadcast load across the columns and each child row is read
// with coalesced loads from the one table its tier selects.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ int64_t clamp_slot(int32_t s, int64_t rows) {
  const int64_t x = s < 0 ? 0 : static_cast<int64_t>(s);
  return x < rows - 1 ? x : rows - 1;
}

template <typename T>
__global__ void gather_aggregate_kernel(
    const int32_t* __restrict__ tier, const int32_t* __restrict__ slot,
    const T* __restrict__ hot, int64_t hot_rows, const T* __restrict__ warm,
    int64_t warm_rows, const T* __restrict__ cold, int64_t cold_rows,
    T* __restrict__ out, int64_t segments, int64_t fan, int64_t d) {
  const int64_t seg =
      static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (seg >= segments) return;
  const int32_t* seg_tier = tier + seg * fan;
  const int32_t* seg_slot = slot + seg * fan;
  for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.0f;
    for (int64_t n = 0; n < fan; ++n) {
      const int32_t t = seg_tier[n];
      float v = 0.0f;
      if (t == 0) {
        v = to_f32(hot[clamp_slot(seg_slot[n], hot_rows) * d + c]);
      } else if (t == 1) {
        v = to_f32(warm[clamp_slot(seg_slot[n], warm_rows) * d + c]);
      } else if (t == 2) {
        v = to_f32(cold[clamp_slot(seg_slot[n], cold_rows) * d + c]);
      }
      acc += v;
    }
    out[seg * d + c] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* tier, const void* slot, const void* hot,
           int64_t hot_rows, const void* warm, int64_t warm_rows,
           const void* cold, int64_t cold_rows, void* out, int64_t segments,
           int64_t fan, int64_t d, void* stream) {
  // columns: d rounded up to a warp, at most one block's worth; the rest of
  // the block's threads take further segments
  int64_t cols = (d + 31) / 32 * 32;
  if (cols > kThreads) cols = kThreads;
  const int64_t segs = kThreads / cols;
  const dim3 block(static_cast<unsigned>(cols), static_cast<unsigned>(segs));
  const int64_t blocks = (segments + segs - 1) / segs;
  gather_aggregate_kernel<T><<<static_cast<unsigned>(blocks), block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tier), static_cast<const int32_t*>(slot),
      static_cast<const T*>(hot), hot_rows, static_cast<const T*>(warm),
      warm_rows, static_cast<const T*>(cold), cold_rows, static_cast<T*>(out),
      segments, fan, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_aggregate_f32(const void* tier, const void* slot,
                                    const void* hot, int64_t hot_rows,
                                    const void* warm, int64_t warm_rows,
                                    const void* cold, int64_t cold_rows,
                                    void* out, int64_t segments, int64_t fan,
                                    int64_t d, void* stream) {
  return launch<float>(tier, slot, hot, hot_rows, warm, warm_rows, cold,
                       cold_rows, out, segments, fan, d, stream);
}

extern "C" int gather_aggregate_bf16(const void* tier, const void* slot,
                                     const void* hot, int64_t hot_rows,
                                     const void* warm, int64_t warm_rows,
                                     const void* cold, int64_t cold_rows,
                                     void* out, int64_t segments, int64_t fan,
                                     int64_t d, void* stream) {
  return launch<__nv_bfloat16>(tier, slot, hot, hot_rows, warm, warm_rows,
                               cold, cold_rows, out, segments, fan, d, stream);
}
