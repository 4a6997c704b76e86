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
// (__fadd_rn, so no contraction can change it). The mean divides with
// __fdiv_rn. That is the arithmetic of the Pallas body and of the plain
// version (kernels/embedding_bag/ref.py, whose fma_f32 rounds once), so
// kernel == plain bitwise. A padded id reads no row: its Pallas term
// valid·w·row is ±0, which leaves an fp32 sum unchanged.
//
// Bound on an H100: HBM bytes. Per call it must read the ids (4 bytes),
// the weights (elem bytes, when given), each valid row once and write
// each output row once: B·bag·(4 [+ elem]) + valid·d·elem + B·d·elem at
// 3.35 TB/s; the valid·d multiply-adds are far below the compute peak.
// At DIN's serve_p99 (512 bags of 100, d 36) the rows sit in L2, and a
// design that loads one row after another is a chain of L2 round trips.
//
// Design: a whole bag in flight. One block (kThreads threads) owns one
// bag at a time, grid-stride over bags, and one kTileCols-column tile of
// it at a time (one tile for d <= 128).
//   - Its threads read the bag's ids kThreads at a time; each warp
//     compacts its valid ones with __ballot_sync and
//     __popc(mask & lanemask_lt), offset by the counts of the warps
//     before it, so slot order is list order; clamped ids and fp32
//     weights go to shared memory beside the ring.
//   - Windows are gathered until the next could overflow the `ring`
//     slots; then all threads issue the cp.async copies of those rows
//     together, spread over (slot, chunk) pairs, wait once
//     (cp.async.wait_group 0) and meet at __syncthreads().
//   - One thread per column folds the slots in order from shared memory,
//     with the valid count for the mean. A bag longer than the ring takes
//     more such passes; the accumulators stay in registers across them.
// The copy width (`chunk`: 16, 8 or 4 bytes, or 0) comes from the
// wrapper's copy plan, from the row's bytes and the table's address;
// 16-byte copies go .cg (L2 only), 8/4-byte ones .ca; with 0 (a bf16 row
// of odd width, a view that starts mid-word) the same kernel stages the
// rows through registers: ld.global, then st.shared.
#include <cstdint>
#include <mutex>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = kThreads;  // one folding thread a column
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block may use
constexpr int kMaxDevices = 64;      // cards a process may launch on
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

// One chunk of a row from global to shared memory.
template <typename T, int kChunk>
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src) {
  if constexpr (kChunk == 0) {
    // register staging: one element, ld.global then st.shared
    *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(src);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (kChunk == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(kChunk) : "memory");
    }
  }
}

// Copy `cnt` tile rows (ids in s_id, slots 0..cnt-1) of `tw` columns
// starting at column c0; the block's threads spread over (slot, chunk).
template <typename T, int kChunk>
__device__ __forceinline__ void issue_copies(unsigned char* ring_data,
                                             int slot_bytes, int cnt,
                                             const int32_t* s_id,
                                             const T* __restrict__ table,
                                             int64_t d, int64_t c0, int tw) {
  constexpr int kStep = kChunk == 0 ? static_cast<int>(sizeof(T)) : kChunk;
  const int nchunk = tw * static_cast<int>(sizeof(T)) / kStep;
  const int tid = threadIdx.x;
  auto one = [&](int j, int ch) {
    const auto* src = reinterpret_cast<const unsigned char*>(
        table + static_cast<int64_t>(s_id[j]) * d + c0);
    copy_chunk<T, kChunk>(ring_data + j * slot_bytes + ch * kStep,
                          src + ch * kStep);
  };
  if (nchunk <= kThreads) {
    const int per = kThreads / nchunk;  // slots a pass
    const int j0 = tid / nchunk;
    const int ch = tid - j0 * nchunk;
    if (j0 < per) {
      for (int j = j0; j < cnt; j += per) one(j, ch);
    }
  } else {
    for (int j = 0; j < cnt; ++j) {
      for (int ch = tid; ch < nchunk; ch += kThreads) one(j, ch);
    }
  }
}

template <typename T, bool kWeighted, bool kMean, int kChunk>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const int32_t* __restrict__ ids,
                         const T* __restrict__ weights,
                         const T* __restrict__ table, int64_t rows,
                         T* __restrict__ out, int64_t batch, int64_t bag,
                         int64_t d, int ring, int slot_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring_data = smem;
  float* s_w = reinterpret_cast<float*>(smem + ring * slot_bytes);
  int32_t* s_id = reinterpret_cast<int32_t*>(s_w + ring);
  int* s_cnt = s_id + ring;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  for (int64_t b = blockIdx.x; b < batch; b += gridDim.x) {
    const int32_t* bag_ids = ids + b * bag;
    const T* bag_w = kWeighted ? weights + b * bag : nullptr;
    for (int64_t c0 = 0; c0 < d; c0 += kTileCols) {
      const int tw = static_cast<int>(d - c0 < kTileCols ? d - c0 : kTileCols);
      float acc = 0.0f;
      int count = 0;
      int64_t pos = 0;
      while (pos < bag) {
        // gather windows of ids, compacted in list order, while they fit
        int filled = 0;
        while (pos < bag && filled + kThreads <= ring) {
          const int64_t k = pos + tid;
          const int32_t id = k < bag ? bag_ids[k] : -1;
          const unsigned mask = __ballot_sync(kFull, id >= 0);
          if (lane == 0) s_cnt[warp] = __popc(mask);
          __syncthreads();
          int before = 0, total = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const int c = s_cnt[w];
            before += w < warp ? c : 0;
            total += c;
          }
          if (id >= 0) {
            const int slot = filled + before + __popc(mask & lt);
            s_id[slot] = id < rows ? id : static_cast<int32_t>(rows - 1);
            if (kWeighted) s_w[slot] = to_f32(bag_w[k]);
          }
          __syncthreads();  // s_cnt is read by all before it is rewritten
          filled += total;
          pos += kThreads;
        }
        // the whole pass in flight at once, one wait
        issue_copies<T, kChunk>(ring_data, slot_bytes, filled, s_id, table,
                                d, c0, tw);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        if (tid < tw) {
#pragma unroll 8
          for (int j = 0; j < filled; ++j) {
            const float v = to_f32(
                reinterpret_cast<const T*>(ring_data + j * slot_bytes)[tid]);
            acc = kWeighted ? __fmaf_rn(v, s_w[j], acc) : __fadd_rn(acc, v);
          }
        }
        count += filled;
        __syncthreads();  // the fold reads the ring before the next pass
      }
      if (tid < tw) {
        if (kMean) acc = __fdiv_rn(acc, fmaxf(static_cast<float>(count), 1.0f));
        out[b * d + c0 + tid] = from_f32<T>(acc);
      }
    }
  }
}

// Lift the dynamic shared memory limit of one instantiation to 227 KB,
// once per device (the attribute is the current device's; executor lanes
// launch from several threads).
template <typename T, bool kWeighted, bool kMean, int kChunk>
cudaError_t allow_smem() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        embedding_bag_kernel<T, kWeighted, kMean, kChunk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  return err[dev];
}

struct Args {
  const int32_t* ids;
  const void* weights;
  const void* table;
  int64_t rows;
  void* out;
  int64_t batch, bag, d;
  int ring, slot_bytes, smem_bytes, grid;
  cudaStream_t stream;
};

template <typename T, bool kWeighted, bool kMean, int kChunk>
int launch_one(const Args& a) {
  const cudaError_t err = allow_smem<T, kWeighted, kMean, kChunk>();
  if (err != cudaSuccess) return static_cast<int>(err);
  embedding_bag_kernel<T, kWeighted, kMean, kChunk>
      <<<a.grid, kThreads, a.smem_bytes, a.stream>>>(
          a.ids, static_cast<const T*>(a.weights),
          static_cast<const T*>(a.table), a.rows, static_cast<T*>(a.out),
          a.batch, a.bag, a.d, a.ring, a.slot_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWeighted, bool kMean>
int dispatch_chunk(int chunk, const Args& a) {
  switch (chunk) {
    case 16: return launch_one<T, kWeighted, kMean, 16>(a);
    case 8: return launch_one<T, kWeighted, kMean, 8>(a);
    case 4: return launch_one<T, kWeighted, kMean, 4>(a);
    case 0: return launch_one<T, kWeighted, kMean, 0>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* ids, const void* weights, const void* table,
           int64_t rows, void* out, int64_t batch, int64_t bag, int64_t d,
           int weighted, int mean, int chunk, int ring, int smem_bytes,
           int grid, void* stream) {
  // the plan's layout must hold the ring, weights, ids and warp counts
  const int64_t tile = d < kTileCols ? d : kTileCols;
  const int slot_bytes =
      static_cast<int>((tile * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 16);
  const int64_t need = static_cast<int64_t>(ring) * (slot_bytes + 8) +
                       4 * kWarps;
  if (ring < kThreads || grid < 1 || smem_bytes > kMaxSmem ||
      need > smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int32_t*>(ids), weights, table, rows, out,
               batch, bag, d, ring, slot_bytes, smem_bytes, grid,
               static_cast<cudaStream_t>(stream)};
  if (weighted && mean) return dispatch_chunk<T, true, true>(chunk, a);
  if (weighted) return dispatch_chunk<T, true, false>(chunk, a);
  if (mean) return dispatch_chunk<T, false, true>(chunk, a);
  return dispatch_chunk<T, false, false>(chunk, a);
}

}  // namespace

extern "C" int embedding_bag_f32(const void* ids, const void* weights,
                                 const void* table, int64_t rows, void* out,
                                 int64_t batch, int64_t bag, int64_t d,
                                 int weighted, int mean, int chunk, int ring,
                                 int smem_bytes, int grid, void* stream) {
  return launch<float>(ids, weights, table, rows, out, batch, bag, d,
                       weighted, mean, chunk, ring, smem_bytes, grid, stream);
}

extern "C" int embedding_bag_bf16(const void* ids, const void* weights,
                                  const void* table, int64_t rows, void* out,
                                  int64_t batch, int64_t bag, int64_t d,
                                  int weighted, int mean, int chunk, int ring,
                                  int smem_bytes, int grid, void* stream) {
  return launch<__nv_bfloat16>(ids, weights, table, rows, out, batch, bag, d,
                               weighted, mean, chunk, ring, smem_bytes, grid,
                               stream);
}
