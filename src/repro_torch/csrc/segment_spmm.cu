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
// Bound on an H100: HBM bytes. Each feat row is gathered once per edge
// (about 25 times on ogb_products) from a table larger than the 50 MB L2,
// so what a call really moves is ~nnz·d·elem, and the ceiling is HBM
// bandwidth on those gathered bytes. Reaching it takes ~25 KB of loads in
// flight per SM (Little's law at 3.35 TB/s and ~1 µs of loaded latency);
// on the card the pace was set by how many warps issue and fold at once
// more than by the bytes each keeps in flight, so the rings are small.
//
// Design: an ordered gather-sum fed by an asynchronous-copy ring in
// shared memory. A persistent grid of kWarps-warp blocks (as many as are
// resident at once); each warp walks "units" (an output row and one
// 32·kVec-column tile of it; one tile for d <= 128) grid-stride, in
// windows of 32 ids of one list, and owns a ring of `ring` slots of one
// tile row each.
//   - Ids: each window's 32 ids reach shared memory by cp.async kWindows
//     windows before the window is issued, in the cp.async group of an
//     earlier window, so no id load stands on the chain of the copies it
//     feeds. At most kMaxPending windows are in flight, so that group has
//     been waited for by then; each lane reads only the id it copied.
//   - Producer: for the next window the warp compacts the valid ids in
//     list order with __ballot_sync and __popc(mask & lanemask_lt),
//     writes their clamped ids (and fp32 weights) beside the ring, and
//     copies those rows into the next free slots. Before it issues, it
//     folds the oldest windows until the new one fits in the free slots.
//     Rows of whole 16-byte units go as one cp.async.bulk a row (lane j
//     copies row j), their bytes counted on the window's mbarrier; rows
//     that are whole 128-byte lines (d 64 fp32) go instead as per-lane
//     16-byte cp.async with the L2 fetching whole lines (.L2::128B, a
//     little faster there on the card, and slower where rows end
//     mid-line); other rows as per-lane 8- or 4-byte cp.async, lanes
//     spread over (slot, chunk) pairs, or (chunk 0: a bf16 row of odd
//     width, a view that starts mid-word) staged through registers,
//     ld.global then st.shared. The copy width and the whole-line case
//     are chosen by the wrapper's copy plan from the row's bytes and the
//     table's address (both copy addresses must be aligned to the size).
//   - Fold: the oldest window is waited for (cp.async.wait_group, with
//     the groups issued after it left in flight, and its mbarrier's
//     phase for bulk copies) and __syncwarp(), since a lane reads slots
//     other lanes filled; then folded in slot order, lane l holding
//     columns kVec·l .. kVec·l + kVec-1 of the tile in fp32 registers
//     (kVec 1, 2 or 4: the fewest that cover min(d, 128)), one vector load
//     from shared memory a slot. After a unit's last window its tile row
//     is written out, one vector store a lane.
//   - The ring does not drain between output rows: the producer runs
//     ahead across units, so the next row's copies are in flight while
//     this row is folded. A slot is refilled only after its fold (the
//     fold's closing __syncwarp orders the reads before new copies).
#include <cstdint>
#include <mutex>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // warps (concurrent output rows) a block
constexpr int kMinBlocks = 4;      // blocks an SM must fit: <= 128 registers
constexpr int kWindows = 8;        // windows of ids copied ahead
constexpr int kMaxPending = 6;     // windows (cp.async groups) in flight
constexpr int kGroups = 8;         // window records and mbarriers
                                   // (> kMaxPending)
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use
constexpr int kMaxDevices = 64;    // cards a process may launch on
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

// kVec consecutive elements, loaded from shared memory as one vector
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One chunk of a row from global to shared memory, a lane's own copy.
// kLines: every row is whole 128-byte lines, so the L2 may fetch each
// line whole at once (.L2::128B), which no row's bytes are wasted on.
template <typename T, int kChunk, bool kLines>
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src) {
  if constexpr (kChunk == 0) {
    // register staging: one element, ld.global then st.shared
    *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(src);
  } else if constexpr (kLines) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(kChunk) : "memory");
  }
}

// A whole tile row from global to shared memory in one bulk copy, its
// bytes counted on the window's mbarrier.
__device__ __forceinline__ void bulk_copy(unsigned char* dst,
                                          const unsigned char* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's newest groups are in flight.
__device__ __forceinline__ void cp_async_wait(unsigned pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// A warp's share of shared memory and its walk over units and windows.
struct Walk {
  uint32_t bars;             // kGroups mbarriers: a window's bulk copies
  unsigned char* ring_data;  // `ring` slots of slot_bytes
  float* s_w;                // per slot: fp32 weight
  int32_t* s_id;             // per slot: clamped row id
  int* s_grp;                // per window in flight: rows | ends-unit << 16
  int32_t* q_id;             // kWindows x 32 ids copied ahead
  int64_t dmax, d, tiles, units, stride;
  int nwin, ring, slot_bytes;
};

// Where the fold stands: the ring's slots and windows, the unit it folds.
template <int kVec>
struct Fold {
  int head, tail, used;     // ring slots: next free, oldest, held
  unsigned issued, done;    // windows (cp.async groups)
  int64_t cu;               // the unit of the oldest window in flight
  float acc[kVec];
};

// Copy the ids of window (u, w) into q_id row `q` (own lane's id only;
// past the list or past the last unit reads as padding), and step (u, w).
__device__ __forceinline__ void prefetch_ids(const Walk& k,
                                             const int32_t* __restrict__ ids,
                                             int lane, int q, int64_t& u,
                                             int& w) {
  int32_t* dst = k.q_id + q * 32 + lane;
  const int64_t col = static_cast<int64_t>(w) * 32 + lane;
  if (u < k.units && col < k.dmax) {
    const int64_t row = k.tiles == 1 ? u : u / k.tiles;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(ids + row * k.dmax + col)
                 : "memory");
  } else {
    *dst = -1;
  }
  if (u < k.units && ++w == k.nwin) {
    w = 0;
    u += k.stride;
  }
}

// Fold the oldest window in flight into the accumulators, in slot order;
// write the unit's tile row out if the window ends it.
template <typename T, bool kWeighted, bool kBulk, int kVec>
__device__ __forceinline__ void fold_oldest(const Walk& k, Fold<kVec>& f,
                                            T* __restrict__ out, int lane) {
  constexpr int kTileCols = 32 * kVec;
  cp_async_wait(f.issued - f.done - 1);
  if (kBulk) {
    mbar_wait(k.bars + 8 * (f.done % kGroups), (f.done / kGroups) & 1);
  }
  __syncwarp();
  const int grp = k.s_grp[f.done % kGroups];
  const int cnt = grp & 0xffff;
  const int64_t row = k.tiles == 1 ? f.cu : f.cu / k.tiles;
  const int64_t c0 = (f.cu - row * k.tiles) * kTileCols;
  const int tw =
      static_cast<int>(k.d - c0 < kTileCols ? k.d - c0 : kTileCols);
  const int my_col = lane * kVec;
  if (my_col < tw) {
    // slots tail .. tail+cnt-1, in two runs where the ring wraps
    const int run = cnt < k.ring - f.tail ? cnt : k.ring - f.tail;
    const unsigned char* base = k.ring_data + my_col * sizeof(T);
    for (int half = 0; half < 2; ++half) {
      const int from = half == 0 ? f.tail : 0;
      const int to = half == 0 ? f.tail + run : cnt - run;
#pragma unroll 4
      for (int slot = from; slot < to; ++slot) {
        const Vec<T, kVec> x = *reinterpret_cast<const Vec<T, kVec>*>(
            base + slot * k.slot_bytes);
        const float w = kWeighted ? k.s_w[slot] : 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float v = to_f32(x.v[e]);
          f.acc[e] = kWeighted ? __fmaf_rn(v, w, f.acc[e])
                               : __fadd_rn(f.acc[e], v);
        }
      }
    }
  }
  f.tail += cnt;
  if (f.tail >= k.ring) f.tail -= k.ring;
  f.used -= cnt;
  ++f.done;
  if (grp >> 16) {
    T* dst = out + row * k.d + c0 + my_col;
    Vec<T, kVec> y;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      y.v[e] = from_f32<T>(f.acc[e]);
      f.acc[e] = 0.0f;
    }
    if (my_col + kVec <= tw &&
        reinterpret_cast<uintptr_t>(dst) % sizeof(Vec<T, kVec>) == 0) {
      *reinterpret_cast<Vec<T, kVec>*>(dst) = y;  // one coalesced store
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (my_col + e < tw) dst[e] = y.v[e];
      }
    }
    f.cu += k.stride;
  }
  __syncwarp();  // every lane's reads of the folded slots come first
}

// How a warp's lanes spread over the (row, chunk) pairs of a tile row of
// `tw` columns: `per` rows a pass, this lane's first row j0 and chunk ch0.
template <typename T, int kStep>
struct Spread {
  int nchunk, per, j0, ch0;
  __device__ __forceinline__ Spread(int tw, int lane) {
    nchunk = tw * static_cast<int>(sizeof(T)) / kStep;
    per = nchunk <= 32 ? 32 / nchunk : 1;
    j0 = nchunk <= 32 ? lane / nchunk : 0;
    ch0 = nchunk <= 32 ? lane - j0 * nchunk : lane;
  }
};

template <typename T, bool kWeighted, int kChunk, int kVec, bool kLines>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    segment_spmm_kernel(const int32_t* __restrict__ ids,
                        const T* __restrict__ weights,
                        const T* __restrict__ feat, int64_t rows,
                        T* __restrict__ out, int64_t n, int64_t dmax,
                        int64_t d, int ring, int slot_bytes, int warp_bytes) {
  constexpr int kTileCols = 32 * kVec;
  constexpr int kStep = kChunk == 0 ? static_cast<int>(sizeof(T)) : kChunk;
  // rows of whole 16-byte units go in one bulk copy each, unless they are
  // whole 128-byte lines (then per-lane copies with the L2 fetching lines)
  constexpr bool kBulk = kChunk == 16 && !kLines;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Walk k;
  unsigned char* mine = smem + warp * warp_bytes;
  k.bars = smem_addr(mine);
  k.ring_data = mine + 8 * kGroups;
  k.s_w = reinterpret_cast<float*>(k.ring_data + ring * slot_bytes);
  k.s_id = reinterpret_cast<int32_t*>(k.s_w + ring);
  k.s_grp = k.s_id + ring;
  k.q_id = k.s_grp + kGroups;
  k.dmax = dmax;
  k.d = d;
  k.tiles = (d + kTileCols - 1) / kTileCols;
  k.units = n * k.tiles;
  k.stride = static_cast<int64_t>(gridDim.x) * kWarps;
  k.nwin = static_cast<int>((dmax + 31) / 32);
  k.ring = ring;
  k.slot_bytes = slot_bytes;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int row_bytes = static_cast<int>(d * static_cast<int64_t>(sizeof(T)));
  const auto* feat_bytes = reinterpret_cast<const unsigned char*>(feat);
  // the spread of a full tile; only a last, narrower tile needs its own
  const int full_tw = d < kTileCols ? static_cast<int>(d) : kTileCols;
  const Spread<T, kStep> full(full_tw, lane);

  if (kBulk && lane == 0) {
    for (int g = 0; g < kGroups; ++g) mbar_init(k.bars + 8 * g);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the first kWindows windows' ids, then one window's ids with each one
  int64_t fu = first;
  int fw = 0;
  for (int q = 0; q < kWindows; ++q) prefetch_ids(k, ids, lane, q, fu, fw);
  cp_async_commit();
  cp_async_wait(0);

  int64_t pu = first;  // producer: the next window to issue (unit, window)
  int pw = 0;
  Fold<kVec> f;
  f.head = f.tail = f.used = 0;
  f.issued = f.done = 0;
  f.cu = first;
#pragma unroll
  for (int e = 0; e < kVec; ++e) f.acc[e] = 0.0f;

  while (pu < k.units) {
    // ≤ kMaxPending - 1 windows in flight: the group that brought this
    // window's ids (window issued - kWindows) has been waited for
    while (f.issued - f.done > kMaxPending - 1) {
      fold_oldest<T, kWeighted, kBulk, kVec>(k, f, out, lane);
    }
    const int q = f.issued % kWindows;
    const int32_t my_id = k.q_id[q * 32 + lane];
    const unsigned mask = __ballot_sync(kFull, my_id >= 0);
    const int cnt = __popc(mask);
    // each lane refills the entry it read (the ballot has used it) with
    // its id of window issued + kWindows; the copy joins this window's group
    prefetch_ids(k, ids, lane, q, fu, fw);
    // make room: a slot is refilled only after its fold
    while (cnt > ring - f.used) {
      fold_oldest<T, kWeighted, kBulk, kVec>(k, f, out, lane);
    }
    const int64_t row = k.tiles == 1 ? pu : pu / k.tiles;
    const int64_t c0 = (pu - row * k.tiles) * kTileCols;
    const int tw = static_cast<int>(d - c0 < kTileCols ? d - c0 : kTileCols);
    if (my_id >= 0) {
      int slot = f.head + __popc(mask & lt);
      if (slot >= ring) slot -= ring;
      k.s_id[slot] = my_id < rows ? my_id : static_cast<int32_t>(rows - 1);
      if (kWeighted) {
        k.s_w[slot] = to_f32(weights[row * dmax + pw * 32 + lane]);
      }
    }
    if (lane == 0) {
      k.s_grp[f.issued % kGroups] = cnt | (pw == k.nwin - 1 ? 1 << 16 : 0);
    }
    __syncwarp();
    const unsigned char* tile_src = feat_bytes + c0 * sizeof(T);
    if constexpr (kBulk) {
      // the window's rows: one bulk copy a row, lane j copying row j,
      // their bytes counted on the window's mbarrier
      const int bytes = tw * static_cast<int>(sizeof(T));
      const uint32_t bar = k.bars + 8 * (f.issued % kGroups);
      if (lane == 0) mbar_expect_tx(bar, cnt * bytes);
      __syncwarp();
      if (lane < cnt) {
        int slot = f.head + lane;
        if (slot >= ring) slot -= ring;
        bulk_copy(k.ring_data + slot * slot_bytes,
                  tile_src + static_cast<int64_t>(k.s_id[slot]) * row_bytes,
                  bytes, bar);
      }
    } else {
      // the window's rows: lanes over (row, chunk) pairs
      const Spread<T, kStep> sp =
          tw == full_tw ? full : Spread<T, kStep>(tw, lane);
      if (sp.j0 < sp.per) {
        for (int j = sp.j0; j < cnt; j += sp.per) {
          int slot = f.head + j;
          if (slot >= ring) slot -= ring;
          const unsigned char* src =
              tile_src + static_cast<int64_t>(k.s_id[slot]) * row_bytes;
          unsigned char* dst = k.ring_data + slot * slot_bytes;
          for (int ch = sp.ch0; ch < sp.nchunk; ch += 32) {
            copy_chunk<T, kChunk, kLines>(dst + ch * kStep,
                                          src + ch * kStep);
          }
        }
      }
    }
    // the ids copied ahead for window issued + kWindows form its group
    cp_async_commit();
    ++f.issued;
    f.head += cnt;
    if (f.head >= ring) f.head -= ring;
    f.used += cnt;
    if (++pw == k.nwin) {
      pw = 0;
      pu += k.stride;
    }
  }
  while (f.done != f.issued) {
    fold_oldest<T, kWeighted, kBulk, kVec>(k, f, out, lane);
  }
}

// Lift the dynamic shared memory limit of one instantiation to 227 KB,
// once per device (the attribute is the current device's; executor lanes
// launch from several threads).
template <typename T, bool kWeighted, int kChunk, int kVec, bool kLines>
cudaError_t allow_smem() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        segment_spmm_kernel<T, kWeighted, kChunk, kVec, kLines>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  return err[dev];
}

struct Args {
  const int32_t* ids;
  const void* weights;
  const void* feat;
  int64_t rows;
  void* out;
  int64_t n, dmax, d;
  int ring, slot_bytes, smem_bytes, grid;  // grid: blocks the work fills
  cudaStream_t stream;
};

template <typename T, bool kWeighted, int kChunk, int kVec, bool kLines>
int launch_one(const Args& a) {
  const auto kernel = segment_spmm_kernel<T, kWeighted, kChunk, kVec, kLines>;
  cudaError_t err = allow_smem<T, kWeighted, kChunk, kVec, kLines>();
  // a persistent grid: as many blocks as are resident at once (registers
  // and shared memory both count), at most one per kWarps units' worth
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarps * 32, a.smem_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = a.grid < per_sm * sms ? a.grid : per_sm * sms;
  kernel<<<grid, kWarps * 32, a.smem_bytes, a.stream>>>(
          a.ids, static_cast<const T*>(a.weights),
          static_cast<const T*>(a.feat), a.rows, static_cast<T*>(a.out), a.n,
          a.dmax, a.d, a.ring, a.slot_bytes, a.smem_bytes / kWarps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWeighted, int kChunk, bool kLines>
int dispatch_vec(int vec, const Args& a) {
  switch (vec) {
    case 1: return launch_one<T, kWeighted, kChunk, 1, kLines>(a);
    case 2: return launch_one<T, kWeighted, kChunk, 2, kLines>(a);
    case 4: return launch_one<T, kWeighted, kChunk, 4, kLines>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool kWeighted>
int dispatch_chunk(int chunk, int lines, int vec, const Args& a) {
  switch (chunk) {
    case 16: return lines ? dispatch_vec<T, kWeighted, 16, true>(vec, a)
                          : dispatch_vec<T, kWeighted, 16, false>(vec, a);
    case 8: return dispatch_vec<T, kWeighted, 8, false>(vec, a);
    case 4: return dispatch_vec<T, kWeighted, 4, false>(vec, a);
    case 0: return dispatch_vec<T, kWeighted, 0, false>(vec, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* ids, const void* weights, const void* feat,
           int64_t rows, void* out, int64_t n, int64_t dmax, int64_t d,
           int weighted, int chunk, int lines, int vec, int ring,
           int smem_bytes, int grid, void* stream) {
  // the plan's layout must hold a warp's ring, its weights and ids, the
  // window records and the ids copied ahead
  const int64_t tile = d < 32 * vec ? d : 32 * vec;
  const int slot_bytes =
      static_cast<int>((tile * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 16);
  const int64_t need = 8 * kGroups +
                       static_cast<int64_t>(ring) * (slot_bytes + 8) +
                       4 * kGroups + 4 * 32 * kWindows;
  if (ring < 32 || grid < 1 || smem_bytes > kMaxSmem ||
      smem_bytes % (16 * kWarps) != 0 || need > smem_bytes / kWarps ||
      d * static_cast<int64_t>(sizeof(T)) > INT32_MAX ||
      (d > 128 && vec != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int32_t*>(ids), weights, feat, rows, out, n,
               dmax, d, ring, slot_bytes, smem_bytes, grid,
               static_cast<cudaStream_t>(stream)};
  return weighted ? dispatch_chunk<T, true>(chunk, lines, vec, a)
                  : dispatch_chunk<T, false>(chunk, lines, vec, a);
}

}  // namespace

extern "C" int segment_spmm_f32(const void* ids, const void* weights,
                                const void* feat, int64_t rows, void* out,
                                int64_t n, int64_t dmax, int64_t d,
                                int weighted, int chunk, int lines, int vec,
                                int ring, int smem_bytes, int grid,
                                void* stream) {
  return launch<float>(ids, weights, feat, rows, out, n, dmax, d, weighted,
                       chunk, lines, vec, ring, smem_bytes, grid, stream);
}

extern "C" int segment_spmm_bf16(const void* ids, const void* weights,
                                 const void* feat, int64_t rows, void* out,
                                 int64_t n, int64_t dmax, int64_t d,
                                 int weighted, int chunk, int lines, int vec,
                                 int ring, int smem_bytes, int grid,
                                 void* stream) {
  return launch<__nv_bfloat16>(ids, weights, feat, rows, out, n, dmax, d,
                               weighted, chunk, lines, vec, ring, smem_bytes,
                               grid, stream);
}
