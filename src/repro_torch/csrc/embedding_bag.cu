// EmbeddingBag (sum / mean over -1-padded bags) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
// (body _bag_kernel). Called by the DIN model's two history reductions
// (models/din.py: the attention-weighted interest sum and the masked
// history mean).
//
//   out[b] = Σ_{j = 0..bag-1, ids[b,j] >= 0} w[b,j] · table[min(ids, V-1)]
//   w = weights[b,j] (fp32), or 1 without weights
//   mean: out[b] /= max(count of ids[b,j] >= 0, 1)
//
// The sum is taken in fp32, sequentially over j = 0, 1, ..., bag-1, then
// cast to the table dtype. A weighted step is one fused multiply-add,
// acc = fma(row, w, acc) (__fmaf_rn): XLA compiles the Pallas body's
// acc + row * w to exactly that. An unweighted step is acc + row
// (__fadd_rn, so no contraction can change it). That is the arithmetic of
// the Pallas body and of the plain version (kernels/embedding_bag/ref.py,
// whose fma_f32 rounds once), so kernel == plain bitwise. A padded id
// reads no row: its Pallas term valid·w·row is ±0, which leaves an fp32
// sum unchanged.
//
// Bound on an H100: HBM bytes. Per call it must read the ids (4 bytes),
// the weights (elem bytes, when given), each valid row once and write
// each output row once: B·bag·(4 [+ elem]) + valid·d·elem + B·d·elem at
// 3.35 TB/s; the valid·d multiply-adds are far below the compute peak.
// Design against that bound: one thread per (bag row b, column c), flat
// over B·d so no thread idles on a ragged d (DIN's d is 36). A warp covers
// one or two bag rows: the id and weight of step j are broadcast loads
// and the row read is one contiguous span per bag row. Each thread keeps
// one fp32 register accumulator and a valid count, so no partial sum is
// written to memory; the TPU kernel's VMEM scratch became registers.
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

template <typename T, bool kWeighted, bool kMean>
__global__ void embedding_bag_kernel(const int32_t* __restrict__ ids,
                                     const T* __restrict__ weights,
                                     const T* __restrict__ table,
                                     int64_t rows, T* __restrict__ out,
                                     int64_t batch, int64_t bag, int64_t d) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * d) return;
  const int64_t b = i / d;
  const int64_t c = i - b * d;
  const int32_t* bag_ids = ids + b * bag;
  const T* bag_w = kWeighted ? weights + b * bag : nullptr;
  float acc = 0.0f;
  float count = 0.0f;
  for (int64_t j = 0; j < bag; ++j) {
    const int32_t id = bag_ids[j];
    if (id < 0) continue;
    const int64_t r = id < rows ? static_cast<int64_t>(id) : rows - 1;
    const float v = to_f32(table[r * d + c]);
    acc = kWeighted ? __fmaf_rn(v, to_f32(bag_w[j]), acc) : __fadd_rn(acc, v);
    count += 1.0f;
  }
  if (kMean) acc = __fdiv_rn(acc, fmaxf(count, 1.0f));
  out[i] = from_f32<T>(acc);
}

template <typename T, bool kWeighted, bool kMean>
void launch_one(const int32_t* ids, const T* weights, const T* table,
                int64_t rows, T* out, int64_t batch, int64_t bag, int64_t d,
                cudaStream_t stream) {
  const int64_t blocks = (batch * d + kThreads - 1) / kThreads;
  embedding_bag_kernel<T, kWeighted, kMean>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          ids, weights, table, rows, out, batch, bag, d);
}

template <typename T>
int launch(const void* ids_v, const void* weights_v, const void* table_v,
           int64_t rows, void* out_v, int64_t batch, int64_t bag, int64_t d,
           int weighted, int mean, void* stream_v) {
  const auto* ids = static_cast<const int32_t*>(ids_v);
  const auto* weights = static_cast<const T*>(weights_v);
  const auto* table = static_cast<const T*>(table_v);
  auto* out = static_cast<T*>(out_v);
  const auto stream = static_cast<cudaStream_t>(stream_v);
  if (weighted && mean) {
    launch_one<T, true, true>(ids, weights, table, rows, out, batch, bag, d,
                              stream);
  } else if (weighted) {
    launch_one<T, true, false>(ids, weights, table, rows, out, batch, bag, d,
                               stream);
  } else if (mean) {
    launch_one<T, false, true>(ids, weights, table, rows, out, batch, bag, d,
                               stream);
  } else {
    launch_one<T, false, false>(ids, weights, table, rows, out, batch, bag,
                                d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embedding_bag_f32(const void* ids, const void* weights,
                                 const void* table, int64_t rows, void* out,
                                 int64_t batch, int64_t bag, int64_t d,
                                 int weighted, int mean, void* stream) {
  return launch<float>(ids, weights, table, rows, out, batch, bag, d,
                       weighted, mean, stream);
}

extern "C" int embedding_bag_bf16(const void* ids, const void* weights,
                                  const void* table, int64_t rows, void* out,
                                  int64_t batch, int64_t bag, int64_t d,
                                  int weighted, int mean, void* stream) {
  return launch<__nv_bfloat16>(ids, weights, table, rows, out, batch, bag, d,
                               weighted, mean, stream);
}
