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
// any input. The Pallas body passes rows through fp32 and casts them back;
// for every non-NaN fp32 and bf16 value that round trip is the identity,
// so the kernel copies bits (and keeps -0.0). A row of another tier reads
// nothing and is written as +0.0, as the plain version's where(..., 0.0).
//
// Bound on an H100: HBM bytes. A pure copy does no arithmetic; it must read
// each selected row once and write each output row once (plus 8 bytes of
// tier/slot per row): ~2·M·d·elem + 8·M bytes at 3.35 TB/s. At the serve
// path's inputs (1,952 rows of d 128 fp32: ~1.1 MB, ~0.3 us) that bound is
// below the time of any launch and a row's cost is its chain of dependent
// round trips, which the design cuts to two: the address, then the row.
//
// Design (the shape of gather_aggregate.cu, without a fold): a row belongs
// to a group of `lanes` lanes, the fewest (a power of two, at most 32)
// that cover it in vectors of kBytes (16 bytes where the row's bytes and
// the tables' and the output's addresses allow; 8, 4, or one element). A
// warp takes 32/lanes consecutive rows and walks such units grid-stride.
// Its lanes load their rows' tier and slot together, unconditionally: one
// load each, which the lanes of a group share (a broadcast), so each lane
// resolves its row's address itself. (A shuffle from the lane that loaded
// it measured ~0.3 us slower at the serve size, where no window of several
// rows a group pays: there a warp has one row.) A lane then issues the
// vector loads of its row, up to kInFlight passes of it, before its first
// store; a row of one pass is one load and one store.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;   // blocks an SM holds at once (registers)
constexpr int kInFlight = 8;    // vectors a lane loads before it stores

// kBytes of a row as 32-bit words (a 2-byte vector: one bf16, low half)
template <int kBytes>
struct Vec {
  uint32_t w[kBytes >= 4 ? kBytes / 4 : 1];
};

template <int kBytes>
__device__ __forceinline__ Vec<kBytes> load_vec(const unsigned char* p) {
  Vec<kBytes> r;
  if constexpr (kBytes == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
    r.w[2] = x.z;
    r.w[3] = x.w;
  } else if constexpr (kBytes == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
  } else if constexpr (kBytes == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

template <int kBytes>
__device__ __forceinline__ void store_vec(unsigned char* p,
                                          const Vec<kBytes>& r) {
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<unsigned int*>(p) = r.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(r.w[0]);
  }
}

// the slot clamped into [0, last] (last = rows - 1; a slot is an int32)
__device__ __forceinline__ int clamp_slot(int32_t s, int last) {
  return min(max(s, 0), last);
}

// kLoads: vectors a lane loads before it stores: 1 when a row is one pass
// (one load and one store, straight-line), else kInFlight. kWarpRow: a
// row is the whole warp (lanes 32; the serve path's d 128 fp32), so the
// lane is the column and a warp takes one row.
template <int kBytes, int kLoads, bool kWarpRow>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tiered_gather_kernel(const int32_t* __restrict__ tier,
                         const int32_t* __restrict__ slot,
                         const unsigned char* __restrict__ hot, int hot_last,
                         const unsigned char* __restrict__ warm,
                         int warm_last, unsigned char* __restrict__ out,
                         int m, int row_vectors, int shift_arg) {
  const int shift = kWarpRow ? 5 : shift_arg;  // lanes = 1 << shift a row
  const int lane = threadIdx.x & 31;
  const int group = lane >> shift;
  const int col0 = lane & ((1 << shift) - 1);
  const int row_bytes = row_vectors * kBytes;
  for (int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) << (5 - shift);
       row0 < m; row0 += (gridDim.x * kWarps) << (5 - shift)) {
    const int row = row0 + group;
    if (row >= m) continue;
    // the group's lanes read the same entry: one broadcast load each
    const int32_t t = __ldg(tier + row);
    const int32_t s = __ldg(slot + row);
    const unsigned char* base = t == 0 ? hot : warm;
    const unsigned char* src =
        t == 0 || t == 1
            ? base + static_cast<int64_t>(
                         clamp_slot(s, t == 0 ? hot_last : warm_last)) *
                         row_bytes
            : nullptr;
    unsigned char* dst = out + static_cast<int64_t>(row) * row_bytes;
    if constexpr (kLoads == 1) {
      if (kWarpRow || col0 < row_vectors) {
        const int at = col0 * kBytes;
        store_vec<kBytes>(dst + at, src != nullptr ? load_vec<kBytes>(src + at)
                                                   : Vec<kBytes>{});
      }
    } else {
      const int passes = (row_vectors + (1 << shift) - 1) >> shift;
      for (int p0 = 0; p0 < passes; p0 += kLoads) {
        Vec<kBytes> v[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int c = ((p0 + i) << shift) + col0;
          if (c < row_vectors) {
            v[i] = src != nullptr ? load_vec<kBytes>(src + c * kBytes)
                                  : Vec<kBytes>{};
          }
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int c = ((p0 + i) << shift) + col0;
          if (c < row_vectors) store_vec<kBytes>(dst + c * kBytes, v[i]);
        }
      }
    }
  }
}

template <int kBytes>
int launch_one(const void* tier, const void* slot, const void* hot,
               int hot_last, const void* warm, int warm_last, void* out,
               int m, int row_vectors, int lanes, int blocks,
               cudaStream_t stream) {
  const auto* t = static_cast<const int32_t*>(tier);
  const auto* s = static_cast<const int32_t*>(slot);
  const auto* h = static_cast<const unsigned char*>(hot);
  const auto* w = static_cast<const unsigned char*>(warm);
  auto* o = static_cast<unsigned char*>(out);
  const int shift = 31 - __builtin_clz(static_cast<unsigned>(lanes));
  if (lanes == 32 && row_vectors == 32) {
    tiered_gather_kernel<kBytes, 1, true><<<blocks, kThreads, 0, stream>>>(
        t, s, h, hot_last, w, warm_last, o, m, row_vectors, shift);
  } else if (row_vectors <= lanes) {
    tiered_gather_kernel<kBytes, 1, false><<<blocks, kThreads, 0, stream>>>(
        t, s, h, hot_last, w, warm_last, o, m, row_vectors, shift);
  } else {
    tiered_gather_kernel<kBytes, kInFlight, false>
        <<<blocks, kThreads, 0, stream>>>(t, s, h, hot_last, w, warm_last, o,
                                          m, row_vectors, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// A copy needs only the element's size: fp32 and bf16 share the bodies.
int launch(int elem, const void* tier, const void* slot, const void* hot,
           int64_t hot_rows, const void* warm, int64_t warm_rows, void* out,
           int64_t m, int64_t d, int vec_bytes, int lanes, int blocks,
           void* stream) {
  // the plan must tile the row in whole vectors, a power-of-two group;
  // rows are counted in 32 bits
  const int64_t row_bytes = d * elem;
  if (vec_bytes < elem || row_bytes % vec_bytes || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || blocks < 1 || hot_rows < 1 || warm_rows < 1 ||
      m + static_cast<int64_t>(blocks) * kThreads > INT32_MAX ||
      row_bytes / vec_bytes > INT32_MAX / 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = static_cast<int>(m);
  const int nvec = static_cast<int>(row_bytes / vec_bytes);
  // a slot is an int32, so clamping to INT32_MAX loses nothing
  const int hl = static_cast<int>(hot_rows - 1 < INT32_MAX ? hot_rows - 1
                                                           : INT32_MAX);
  const int wl = static_cast<int>(warm_rows - 1 < INT32_MAX ? warm_rows - 1
                                                            : INT32_MAX);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_one<16>(tier, slot, hot, hl, warm, wl, out, rows,
                                   nvec, lanes, blocks, st);
    case 8: return launch_one<8>(tier, slot, hot, hl, warm, wl, out, rows,
                                 nvec, lanes, blocks, st);
    case 4: return launch_one<4>(tier, slot, hot, hl, warm, wl, out, rows,
                                 nvec, lanes, blocks, st);
    case 2: return launch_one<2>(tier, slot, hot, hl, warm, wl, out, rows,
                                 nvec, lanes, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int tiered_gather_f32(const void* tier, const void* slot,
                                 const void* hot, int64_t hot_rows,
                                 const void* warm, int64_t warm_rows,
                                 void* out, int64_t m, int64_t d,
                                 int vec_bytes, int lanes, int blocks,
                                 void* stream) {
  return launch(4, tier, slot, hot, hot_rows, warm, warm_rows, out, m, d,
                vec_bytes, lanes, blocks, stream);
}

extern "C" int tiered_gather_bf16(const void* tier, const void* slot,
                                  const void* hot, int64_t hot_rows,
                                  const void* warm, int64_t warm_rows,
                                  void* out, int64_t m, int64_t d,
                                  int vec_bytes, int lanes, int blocks,
                                  void* stream) {
  return launch(2, tier, slot, hot, hot_rows, warm, warm_rows, out, m, d,
                vec_bytes, lanes, blocks, stream);
}
