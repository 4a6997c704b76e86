// Two-source tiered row gather for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tiered_gather/kernel.py::tiered_gather_pallas
// (body _tiered_kernel), called by TieredFeatureStore._fused_unique.
//
//   out[i] = hot[clamp(slot[i])]   if tier[i] == 0
//            warm[clamp(slot[i])]  if tier[i] == 1
//            0                     otherwise (pad rows carry tier 99)
//
// The slot is clamped to [0, rows-1] of the selected table, exactly as the
// plain version (kernels/tiered_gather/ref.py) does, so kernel == plain on
// any input. Rows pass through fp32 and are cast back, as on the TPU; for
// fp32 and bf16 that round trip is exact, so the result is a bitwise copy.
//
// Bound on an H100: HBM bytes. A pure copy does no arithmetic; it must read
// each selected row once and write each output row once (plus 8 bytes of
// tier/slot per row): ~2·M·d·elem + 8·M bytes at 3.35 TB/s.
// Design against that bound: one warp per output row; the warp reads the
// row's tier/slot once (a broadcast load) and its lanes stride along d, so
// each row is read and written with coalesced 128-byte transactions and
// only from the table that tier selects (the Pallas body reads both tables
// and selects). Rows whose tier is neither 0 nor 1 read nothing.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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
__global__ void tiered_gather_kernel(const int32_t* __restrict__ tier,
                                     const int32_t* __restrict__ slot,
                                     const T* __restrict__ hot,
                                     int64_t hot_rows,
                                     const T* __restrict__ warm,
                                     int64_t warm_rows, T* __restrict__ out,
                                     int64_t m, int64_t d) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  const int32_t t = tier[row];
  const T* src = nullptr;
  if (t == 0) {
    src = hot + clamp_slot(slot[row], hot_rows) * d;
  } else if (t == 1) {
    src = warm + clamp_slot(slot[row], warm_rows) * d;
  }
  T* dst = out + row * d;
  for (int64_t c = lane; c < d; c += 32) {
    const float v = src != nullptr ? to_f32(src[c]) : 0.0f;
    dst[c] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* tier, const void* slot, const void* hot,
           int64_t hot_rows, const void* warm, int64_t warm_rows, void* out,
           int64_t m, int64_t d, void* stream) {
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tiered_gather_kernel<T><<<static_cast<unsigned>(blocks),
                            kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tier), static_cast<const int32_t*>(slot),
      static_cast<const T*>(hot), hot_rows, static_cast<const T*>(warm),
      warm_rows, static_cast<T*>(out), m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tiered_gather_f32(const void* tier, const void* slot,
                                 const void* hot, int64_t hot_rows,
                                 const void* warm, int64_t warm_rows,
                                 void* out, int64_t m, int64_t d,
                                 void* stream) {
  return launch<float>(tier, slot, hot, hot_rows, warm, warm_rows, out, m, d,
                       stream);
}

extern "C" int tiered_gather_bf16(const void* tier, const void* slot,
                                  const void* hot, int64_t hot_rows,
                                  const void* warm, int64_t warm_rows,
                                  void* out, int64_t m, int64_t d,
                                  void* stream) {
  return launch<__nv_bfloat16>(tier, slot, hot, hot_rows, warm, warm_rows,
                               out, m, d, stream);
}
