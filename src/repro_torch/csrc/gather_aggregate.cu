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
// The sum is taken in fp32, sequentially over n = 0, 1, ..., fan-1, from
// +0.0 with __fadd_rn, then cast to the table dtype. That order is the
// contract of the Pallas kernel and of the plain version
// (kernels/gather_aggregate/ref.py), so kernel == plain bitwise, and the
// fused serve path == the unfused one. An invalid child reads nothing:
// the plain version adds +0.0 for it, and an fp32 sum that starts at +0.0
// is never -0.0 under round-to-nearest, so acc + 0.0 == acc bitwise. The
// first row is added to +0.0, never taken as the start: the plain version
// turns a -0.0 singleton into +0.0.
//
// Bound on an H100: HBM bytes. Per call it must read 8 bytes of tier/slot
// per child, each valid child row once and write each output row once:
// 8·S·fan + valid_children·d·elem + S·d·elem bytes at 3.35 TB/s; the
// valid_children·d fp32 adds are far below the compute peak. At the serve
// path's inputs (2,272 segments of fan 5, d 128 fp32: ~1.3 MB, ~0.4 us)
// that bound is below the time of any launch, the rows sit in L2, and what
// a segment costs is its chain of dependent round trips. The design cuts
// that chain to two: the addresses, then every row at once.
//
// Design: latency first.
//   - A segment belongs to a group of `lanes` lanes, the fewest (a power
//     of two, at most 32) that cover a row in vectors of kBytes (16 bytes
//     where the row's bytes and every table's and the output's addresses
//     allow; 8, 4, or one element). A warp takes 32/lanes consecutive
//     segments, whose fan·32/lanes tier/slot entries are contiguous, and
//     walks such units grid-stride; the wrapper sizes the grid so that at
//     the serve size every unit has its own warp.
//   - The warp reads a window of 32 entries at once: one coalesced load of
//     tier and one of slot, issued together. Each lane resolves its entry
//     to a row address (the table its tier selects, the slot clamped; none
//     for any other tier).
//   - Each group takes its children in that window in list order,
//     kInFlight at a time: every lane fetches each child's address from
//     the lane that resolved it (__shfl_sync) and issues all of those
//     vector loads into registers before the first add; then it folds
//     them in order. Fans longer than a window run in windows.
//   - One vector store a lane. Rows wider than lanes·kBytes take passes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;   // blocks an SM holds at once (registers)
constexpr int kInFlight = 8;    // child rows a lane loads before it folds
constexpr unsigned kFull = 0xffffffffu;

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

// element e of a vector, exactly, as fp32
template <typename T, int kBytes>
__device__ __forceinline__ float element(const Vec<kBytes>& v, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(v.w[e]);
  } else {
    const uint32_t w = v.w[e >> 1];
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
}

// fp32 sums → a vector of T (bf16 rounds to nearest even, as .to() does)
template <typename T, int kBytes, int kElems>
__device__ __forceinline__ Vec<kBytes> pack(const float (&acc)[kElems]) {
  Vec<kBytes> r;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    if constexpr (sizeof(T) == 4) {
      r.w[e] = __float_as_uint(acc[e]);
    } else {
      const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16(acc[e]));
      if (e & 1) {
        r.w[e >> 1] |= bits << 16;
      } else {
        r.w[e >> 1] = bits;
      }
    }
  }
  return r;
}

// the three tables; `last` is each one's rows - 1 (at most INT32_MAX: a
// slot is an int32, so clamping there loses nothing)
struct Tables {
  const unsigned char* hot;
  const unsigned char* warm;
  const unsigned char* cold;
  int hot_last, warm_last, cold_last, row_bytes;
};

// the row a (tier, slot) entry names, the slot clamped into its table,
// or nullptr (contributes nothing)
__device__ __forceinline__ const unsigned char* row_address(
    int32_t t, int32_t s, const Tables& tb) {
  const unsigned char* base = t == 0 ? tb.hot : t == 1 ? tb.warm : tb.cold;
  const int last = t == 0 ? tb.hot_last : t == 1 ? tb.warm_last : tb.cold_last;
  const int row = min(max(s, 0), last);
  return static_cast<unsigned>(t) < 3u
             ? base + static_cast<int64_t>(row) * tb.row_bytes
             : nullptr;
}

template <typename T, int kBytes>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gather_aggregate_kernel(const int32_t* __restrict__ tier,
                            const int32_t* __restrict__ slot,
                            const Tables tb, unsigned char* __restrict__ out,
                            int64_t segments, int64_t fan, int row_vectors,
                            int lanes) {
  constexpr int kElems = kBytes / sizeof(T) > 0 ? kBytes / sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const int shift = 31 - __clz(lanes);       // lanes is a power of two
  const int per_warp = 32 >> shift;          // segments a unit
  const int group = lane >> shift;
  const int col0 = lane & (lanes - 1);
  const int passes = (row_vectors + lanes - 1) >> shift;
  const int64_t units = (segments + per_warp - 1) / per_warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       u < units; u += stride) {
    const int64_t seg0 = u * per_warp;
    const int64_t rest = segments - seg0;
    const int nseg = rest < per_warp ? static_cast<int>(rest) : per_warp;
    const bool has_seg = group < nseg;
    const int64_t base = seg0 * fan;         // the unit's first entry
    const int64_t entries = nseg * fan;
    const int64_t mine_lo = group * fan;     // this group's entries
    const int64_t mine_hi = mine_lo + fan;
    for (int p = 0; p < passes; ++p) {
      const int c = (p << shift) + col0;     // this lane's vector of a row
      const bool col = c < row_vectors;
      float acc[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = 0.0f;
      for (int64_t w0 = 0; w0 < entries; w0 += 32) {
        const unsigned char* src = nullptr;
        if (w0 + lane < entries) {
          const int32_t t = __ldg(tier + base + w0 + lane);
          const int32_t s = __ldg(slot + base + w0 + lane);
          src = row_address(t, s, tb);
        }
        // this group's children in the window, as the lanes holding them
        int64_t lo = mine_lo - w0, hi = mine_hi - w0;
        lo = lo < 0 ? 0 : lo > 32 ? 32 : lo;
        hi = hi < lo ? lo : hi > 32 ? 32 : hi;
        const int first = has_seg ? static_cast<int>(lo) : 0;
        const int count = has_seg ? static_cast<int>(hi - lo) : 0;
        const int steps = static_cast<int>(
            __reduce_max_sync(kFull, static_cast<unsigned>(count)));
        for (int k = 0; k < steps; k += kInFlight) {
          Vec<kBytes> v[kInFlight];
          unsigned got = 0;
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            if (k + i < steps) {             // the same in every lane
              const auto* a = reinterpret_cast<const unsigned char*>(
                  __shfl_sync(kFull, reinterpret_cast<unsigned long long>(src),
                              (first + k + i) & 31));
              if (k + i < count && a != nullptr && col) {
                v[i] = load_vec<kBytes>(a + static_cast<int64_t>(c) * kBytes);
                got |= 1u << i;
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            if (got >> i & 1u) {
#pragma unroll
              for (int e = 0; e < kElems; ++e) {
                acc[e] = __fadd_rn(acc[e], element<T, kBytes>(v[i], e));
              }
            }
          }
        }
      }
      if (has_seg && col) {
        store_vec<kBytes>(out + (seg0 + group) * tb.row_bytes +
                              static_cast<int64_t>(c) * kBytes,
                          pack<T, kBytes, kElems>(acc));
      }
    }
  }
}

template <typename T, int kBytes>
int launch_one(const int32_t* tier, const int32_t* slot, const Tables& tb,
               void* out, int64_t segments, int64_t fan, int row_vectors,
               int lanes, int blocks, cudaStream_t stream) {
  gather_aggregate_kernel<T, kBytes><<<blocks, kThreads, 0, stream>>>(
      tier, slot, tb, static_cast<unsigned char*>(out), segments, fan,
      row_vectors, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* tier, const void* slot, const void* hot,
           int64_t hot_rows, const void* warm, int64_t warm_rows,
           const void* cold, int64_t cold_rows, void* out, int64_t segments,
           int64_t fan, int64_t d, int vec_bytes, int lanes, int blocks,
           void* stream) {
  // the plan must tile the row in whole vectors, a power-of-two group
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(T));
  if (vec_bytes < static_cast<int>(sizeof(T)) || row_bytes % vec_bytes ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || blocks < 1 ||
      hot_rows < 1 || warm_rows < 1 || cold_rows < 1 ||
      row_bytes > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto last = [](int64_t rows) {
    return static_cast<int>(rows - 1 < INT32_MAX ? rows - 1 : INT32_MAX);
  };
  const Tables tb{static_cast<const unsigned char*>(hot),
                  static_cast<const unsigned char*>(warm),
                  static_cast<const unsigned char*>(cold),
                  last(hot_rows), last(warm_rows), last(cold_rows),
                  static_cast<int>(row_bytes)};
  const auto* t = static_cast<const int32_t*>(tier);
  const auto* s = static_cast<const int32_t*>(slot);
  const int nvec = static_cast<int>(row_bytes / vec_bytes);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_one<T, 16>(t, s, tb, out, segments, fan, nvec,
                                      lanes, blocks, st);
    case 8: return launch_one<T, 8>(t, s, tb, out, segments, fan, nvec,
                                    lanes, blocks, st);
    case 4: return launch_one<T, 4>(t, s, tb, out, segments, fan, nvec,
                                    lanes, blocks, st);
    case 2:
      if constexpr (sizeof(T) == 2) {
        return launch_one<T, 2>(t, s, tb, out, segments, fan, nvec, lanes,
                                blocks, st);
      }
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gather_aggregate_f32(const void* tier, const void* slot,
                                    const void* hot, int64_t hot_rows,
                                    const void* warm, int64_t warm_rows,
                                    const void* cold, int64_t cold_rows,
                                    void* out, int64_t segments, int64_t fan,
                                    int64_t d, int vec_bytes, int lanes,
                                    int blocks, void* stream) {
  return launch<float>(tier, slot, hot, hot_rows, warm, warm_rows, cold,
                       cold_rows, out, segments, fan, d, vec_bytes, lanes,
                       blocks, stream);
}

extern "C" int gather_aggregate_bf16(const void* tier, const void* slot,
                                     const void* hot, int64_t hot_rows,
                                     const void* warm, int64_t warm_rows,
                                     const void* cold, int64_t cold_rows,
                                     void* out, int64_t segments, int64_t fan,
                                     int64_t d, int vec_bytes, int lanes,
                                     int blocks, void* stream) {
  return launch<__nv_bfloat16>(tier, slot, hot, hot_rows, warm, warm_rows,
                               cold, cold_rows, out, segments, fan, d,
                               vec_bytes, lanes, blocks, stream);
}
