// Flash attention (causal or full, GQA) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _flash_kernel). Called by the LM prefill in
// place of the reference's blockwise_attention, one launch per layer.
//
//   s    = (q . k) * scale                     fp32, scale = 1/sqrt(dh)
//   mask = kv_pos < Skv && (!causal || kv_pos <= q_pos)   (top-left)
//   s    = mask ? s : -1e30
//   online softmax over kv tiles, in order:
//     m_new = max(m, rowmax s); p = exp(s - m_new); corr = exp(m - m_new)
//     l = l * corr + sum p;  acc = acc * corr + p . v   (p, v, acc fp32)
//   out  = acc / max(l, 1e-20), cast to q's type
// Query head h reads kv head h / (H / KV). That is the Pallas body's
// arithmetic and the plain version's (kernels/flash_attention/ref.py); the
// kernel's tiles differ from its 128-key blocks, which changes only the
// fp32 rounding (an online softmax is exact over any tiling).
//
// Bound on an H100: operations. A causal prefill of S tokens does
// 4 * B * H * dh * S(S+1)/2 flops (8.8e12 a qwen3-4b layer at 32k) and
// reads q, k, v once (0.4 GB), so the bf16 tensor-core peak bounds it.
//
// bf16 (what the LM serves): wgmma fed by a TMA ring.
// - p stays fp32, as the contract says, yet p . v runs on the tensor
//   cores: each p is split into three bf16 terms, hi = bf16(p),
//   mid = bf16(p - hi), lo = bf16(p - hi - mid). hi + mid + lo == p
//   exactly for every p >= 2^-110 = 7.7e-34 (three 8-bit significands
//   cover fp32's 24; below, the error is under 2^-134), each bf16 x bf16
//   product is exact in fp32, so hi.v + mid.v + lo.v under fp32 sums is
//   the fp32 p . v up to summation order. The tensor core's sums are not
//   fp32 rounding (it truncates as it accumulates; see p . v below), so
//   the kernel keeps them short and the card checks pin the result. Two
//   terms would leave up to 7.6e-6 relative error on each p.
// - So the tensor work is q.k^T plus three p . v products: twice the
//   8.8e12 the bound counts. SDPA rounds p to bf16 and does one p . v;
//   under this contract the kernel cannot reach it (ratio >= 2 at the
//   tensor-core rate, more with the split and exp on the CUDA cores).
// - One CTA per (b, h, 128-query tile), tiles issued longest-causal-first
//   (heads vary fastest). Three warpgroups: a producer (its first thread
//   issues every TMA load; setmaxnreg gives its registers away, which
//   needs the whole warpgroup) and two consumers of 64 query rows each.
//   The producer loads Q once and streams 128-key K and V tiles through a
//   two-stage ring with cp.async.bulk.tensor and full/empty mbarriers
//   (K and V separately, so q.k^T starts before V lands). The tensor maps
//   are 3-D, (B, S, H|KV * dh): rows past Sq or Skv arrive as zeros and a
//   tile never reads the next sequence's rows.
// - Shared tiles are column panels of P = min(dh, 64) bf16 (32 for dh
//   96) rows, swizzled by TMA at 2P bytes (128B for dh 64/128, 64B for
//   32/96, 32B for 16) as wgmma's descriptors expect.
// - q.k^T: wgmma m64n128k16, Q and K from shared memory (K-major). Scale,
//   mask (only on tiles that cross the diagonal or Skv) and the online
//   softmax stay in the accumulator's registers: a row lives in one lane
//   quad, so its max is two xor-shuffles; l is summed per lane and
//   reduced once at the end. exp is ex2.approx on (s - m) * log2(e).
// - p . v: the accumulator layout of S is the register-A layout of the
//   next wgmma, so hi/mid/lo are packed in place (cvt.rn.bf16x2.f32) and
//   three register-A wgmma m64n(dh)k16 per 16 keys add into one fp32
//   accumulator, with V (MN-major, transposed by the descriptor) from
//   shared memory. That accumulator holds one tile's p . v only: the
//   tensor core truncates as it accumulates, and summed over a whole 32k
//   row its error reached 2e-5 on outputs that cancel to near zero (off
//   the bf16 tolerance at qwen3-4b's layer 35). acc = acc * corr + pv
//   then runs in fp32 on the CUDA cores, the FMAs the rescale needed
//   anyway, at the cost of dh/2 more registers a thread.
// - Epilogue: acc / max(l, 1e-20) rounded to bf16, stored from registers;
//   rows >= Sq are not written.
// fp32 (checks only): the earlier CUDA-core body, one CTA of 4 warps per
// (b, h, 64-query tile), K and V staged in shared memory, q.k^T and p.v
// as fp32 FMAs.
// Registers and spills: nvcc -Xptxas -v (numbers in PERF.md).
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskValue = -1e30f;

// Error codes beside cudaError_t's (all positive).
constexpr int kNoTensorMapEncoder = -1;  // no cuTensorMapEncodeTiled in the CUDA driver
constexpr int kTensorMapRefused = -2;    // cuTensorMapEncodeTiled failed

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kTile = 64;  // queries per CTA, and keys per staged tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Q/K rows padded by 16 bytes so the rows a lane quad reads fall on
// distinct banks.
template <int DH>
struct Smem {
  static constexpr int kStride = DH + 4;  // Q and K rows, in floats
  static constexpr size_t kQBytes = sizeof(float) * kTile * kStride;
  static constexpr size_t kKBytes = sizeof(float) * kTile * kStride;
  static constexpr size_t kVBytes = sizeof(float) * kTile * DH;
  static constexpr size_t kBytes = kQBytes + kKBytes + kVBytes;
};

// Copy kTile rows of DH floats (row r at src + r * src_stride) into
// shared memory at `stride` floats a row, rows past `valid` as zeros.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const float* src,
                                           int64_t src_stride, int valid) {
  constexpr int kChunks = DH / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 4;
    float4 raw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < valid) {
      raw = *reinterpret_cast<const float4*>(src + row * src_stride + col);
    }
    *reinterpret_cast<float4*>(dst + row * stride + col) = raw;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int64_t sq, int64_t skv, int64_t heads,
                           int64_t kv_heads, float scale, int causal) {
  using S = Smem<DH>;
  constexpr int kCols = DH / 4;  // output columns a lane keeps per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + S::kQBytes);
  float* vs = reinterpret_cast<float*>(smem + S::kQBytes + S::kKBytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane >> 2;  // rows group and group + 8 of the warp
  const int quad = lane & 3;
  const int64_t tile = gridDim.x - 1 - blockIdx.x;  // longest first
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / (heads / kv_heads);
  const int64_t q0 = tile * kTile;
  const int64_t q_stride = heads * DH;
  const int64_t kv_stride = kv_heads * DH;
  const float* q_base = q + ((b * sq + q0) * heads + h) * DH;
  const float* k_base = k + (b * skv * kv_heads + kvh) * DH;
  const float* v_base = v + (b * skv * kv_heads + kvh) * DH;

  stage_rows<DH>(qs, S::kStride, q_base, q_stride,
                 static_cast<int>(imin(kTile, sq - q0)));

  const int r0 = warp * 16 + group;  // this lane's rows: r0 and r0 + 8
  const int64_t qpos0 = q0 + r0;
  const int64_t qpos1 = qpos0 + 8;

  float acc[2][kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[0][c] = acc[1][c] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.0f, 0.0f};

  int64_t kv_end = skv;
  if (causal) kv_end = imin(skv, q0 + kTile);  // keys <= last row
  for (int64_t kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    const int valid = static_cast<int>(imin(kTile, skv - kv0));
    __syncthreads();  // Q is staged; the previous K/V are no longer read
    stage_rows<DH>(ks, S::kStride, k_base + kv0 * kv_stride, kv_stride,
                   valid);
    stage_rows<DH>(vs, DH, v_base + kv0 * kv_stride, kv_stride, valid);
    __syncthreads();

    // s[t][0..1]: row r0, keys t*8 + quad*2 + {0,1}; s[t][2..3]: row r0+8
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
    {
      const float* qa = qs + r0 * S::kStride;
      const float* qb = qa + 8 * S::kStride;
      const float* kb = ks + quad * 2 * S::kStride;
      for (int kk = 0; kk < DH; kk += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qa + kk);
        const float4 c = *reinterpret_cast<const float4*>(qb + kk);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kv = *reinterpret_cast<const float4*>(
                kb + (t * 8 + e) * S::kStride + kk);
            float x = s[t][e], y = s[t][2 + e];
            x = fmaf(a.x, kv.x, x); x = fmaf(a.y, kv.y, x);
            x = fmaf(a.z, kv.z, x); x = fmaf(a.w, kv.w, x);
            y = fmaf(c.x, kv.x, y); y = fmaf(c.y, kv.y, y);
            y = fmaf(c.z, kv.z, y); y = fmaf(c.w, kv.w, y);
            s[t][e] = x;
            s[t][2 + e] = y;
          }
        }
      }
    }

    // scale, mask, and the online-softmax update of rows r0 and r0 + 8
    float mx[2] = {kMaskValue, kMaskValue};  // every s >= kMaskValue
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t kv_pos = kv0 + t * 8 + quad * 2 + (i & 1);
        const int64_t q_pos = i < 2 ? qpos0 : qpos1;
        const bool keep = kv_pos < skv && (!causal || kv_pos <= q_pos);
        s[t][i] = keep ? s[t][i] * scale : kMaskValue;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[t][i]);
      }
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[t][i] = expf(s[t][i] - m[i >> 1]);
        sum[i >> 1] += s[t][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr[r];
    }

    // acc += p . v in fp32: lane keeps columns quad*4 + 16*j + {0..3}
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int src = (lane & ~3) | (e >> 1);
        const float p0 = __shfl_sync(kFull, s[t][e & 1], src);
        const float p1 = __shfl_sync(kFull, s[t][2 + (e & 1)], src);
        const float* vr = vs + (t * 8 + e) * DH + quad * 4;
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(vr + j * 16);
          acc[0][4 * j + 0] = fmaf(p0, x.x, acc[0][4 * j + 0]);
          acc[0][4 * j + 1] = fmaf(p0, x.y, acc[0][4 * j + 1]);
          acc[0][4 * j + 2] = fmaf(p0, x.z, acc[0][4 * j + 2]);
          acc[0][4 * j + 3] = fmaf(p0, x.w, acc[0][4 * j + 3]);
          acc[1][4 * j + 0] = fmaf(p1, x.x, acc[1][4 * j + 0]);
          acc[1][4 * j + 1] = fmaf(p1, x.y, acc[1][4 * j + 1]);
          acc[1][4 * j + 2] = fmaf(p1, x.z, acc[1][4 * j + 2]);
          acc[1][4 * j + 3] = fmaf(p1, x.w, acc[1][4 * j + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t pos = r == 0 ? qpos0 : qpos1;
    if (pos >= sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
    float* out = o + ((b * sq + pos) * heads + h) * DH + quad * 4;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[j * 16 + i] = acc[r][4 * j + i] / den;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t sq, int64_t skv, int64_t heads,
           int64_t kv_heads, float scale, int causal, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel<DH>;
  const size_t smem = Smem<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kTile - 1) / kTile),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, heads,
      kv_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBlockM = 128;  // queries per CTA: two consumers of 64 rows
constexpr int kBlockN = 128;  // keys per K/V tile (the q.k^T wgmma's N)
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128*24 + 256*240 <= 65536
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  // columns of one swizzled panel, and its row in bytes (= swizzle span)
  static constexpr int kPanel = DH == 96 ? 32 : (DH < 64 ? DH : 64);
  static constexpr int kPanels = DH / kPanel;
  static constexpr uint32_t kRowBytes = 2 * kPanel;
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr uint32_t kQPanelBytes = kBlockM * kRowBytes;
  static constexpr uint32_t kKVPanelBytes = kBlockN * kRowBytes;
  static constexpr uint32_t kQBytes = kBlockM * DH * 2;
  static constexpr uint32_t kTileBytes = kBlockN * DH * 2;  // K or V tile
  static constexpr uint32_t kKOff = kQBytes;
  static constexpr uint32_t kVOff = kKOff + kStages * kTileBytes;
  static constexpr uint32_t kBarOff = kVOff + kStages * kTileBytes;
  static constexpr int kBars = 1 + 4 * kStages;
  // + 1 KB to align the base: 128B swizzle repeats every 1024 bytes
  static constexpr uint32_t kSmem = kBarOff + 8 * kBars + 1024;
  static_assert(kQPanelBytes % 1024 == 0 && kKVPanelBytes % 1024 == 0,
                "panels must keep the swizzle atoms aligned");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers in place around wgmma: the compiler may not move their
// reads or writes across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// The wgmma forms this kernel issues, written out: m64n128k16 with A and B
// from shared memory (q.k^T; scale_d 0 overwrites the accumulator), and
// m64n(dh)k16 with A from registers and B transposed (p.v).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, b, scale_d);
  else wgmma_rs_n128(d, a, b, scale_d);
}

// Two fp32 values as a bf16x2 register, the first in the low half (the A
// fragment's lower column).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float low_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float high_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// p0, p1 -> hi, mid, lo with hi + mid + lo == p (ref.split_bf16x3). Each
// subtraction is exact: the residual fits in fp32's significand.
__device__ __forceinline__ void split_bf16x3(float p0, float p1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(p0, p1);
  p0 -= low_bf16(hi);
  p1 -= high_bf16(hi);
  mid = pack_bf16(p0, p1);
  p0 -= low_bf16(mid);
  p1 -= high_bf16(mid);
  lo = pack_bf16(p0, p1);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o, int sq, int skv,
                           int heads, int kv_heads, float scale, int causal) {
  using C = Cfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kKOff;
  const uint32_t v_s = base + C::kVOff;
  const uint32_t bars = base + C::kBarOff;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int h = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // longest causal first
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = tile * kBlockM;
  const int kv_end = causal ? min(skv, q0 + kBlockM) : skv;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load(q_s + p * C::kQPanelBytes, &q_map, q_full,
                 h * DH + p * C::kPanel, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load(k_s + s * C::kTileBytes + p * C::kKVPanelBytes, &k_map,
                   k_full(s), kvh * DH + p * C::kPanel, j * kBlockN, b);
        }
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load(v_s + s * C::kTileBytes + p * C::kKVPanelBytes, &v_map,
                   v_full(s), kvh * DH + p * C::kPanel, j * kBlockN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes rows 0-63 of the tile, warpgroup 2 64-127
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wgi = warp / 4 - 1;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + wgi * 64 + (warp % 4) * 16 + lane / 4;  // and +8
  const int col = 2 * (lane % 4);  // accumulator columns col, col + 1
  const int wg_first_row = q0 + wgi * 64;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int kv0 = j * kBlockN;

    // s = q . k^T for this warpgroup's 64 rows and the tile's 128 keys
    float sc[kBlockN / 2];
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int panel = kk * 16 / C::kPanel;
      const uint32_t in_row = (kk * 16 % C::kPanel) * 2;
      const uint64_t a = desc(q_s + panel * C::kQPanelBytes +
                                  wgi * 64 * C::kRowBytes + in_row,
                              16, 8 * C::kRowBytes, C::kLayout);
      const uint64_t bk = desc(k_s + s * C::kTileBytes +
                                   panel * C::kKVPanelBytes + in_row,
                               16, 8 * C::kRowBytes, C::kLayout);
      wgmma_ss_n128(sc, a, bk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty(s));

    // scale, mask, online softmax. sc[4c + e]: row row0 + 8 * (e >> 1),
    // key kv0 + 8c + col + (e & 1).
    const bool masked = kv0 + kBlockN > skv ||
                        (causal && kv0 + kBlockN - 1 > wg_first_row);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int c = 0; c < kBlockN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * c + e] * scale;
        if (masked) {
          const int kv = kv0 + 8 * c + col + (e & 1);
          const int qp = row0 + 8 * (e >> 1);
          if (kv >= skv || (causal && kv > qp)) x = kMaskValue;
        }
        sc[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int c = 0; c < kBlockN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx((sc[4 * c + e] - m[e >> 1]) * kLog2e);
        sc[4 * c + e] = p;
        l[e >> 1] += p;
      }
    }

    // p = hi + mid + lo, packed as the register-A fragments of 16 keys:
    // a[0] row r keys 2q..2q+1, a[1] row r+8, a[2]/a[3] keys +8
    uint32_t hi[kBlockN / 16][4], mid[kBlockN / 16][4], lo[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 2 * kk + (i >> 1);
        const int e = 2 * (i & 1);
        split_bf16x3(sc[4 * c + e], sc[4 * c + e + 1], hi[kk][i], mid[kk][i],
                     lo[kk][i]);
      }
    }
    fence_regs(hi);
    fence_regs(mid);
    fence_regs(lo);

    // pv = hi.v + mid.v + lo.v for this tile alone: V is MN-major, 16 keys
    // are 16 panel rows. The tensor core truncates as it accumulates, so a
    // sum over the whole row would drift on outputs that cancel; a tile's
    // 3 * kBlockN / 16 steps do not.
    float pv[DH / 2];
    mbar_wait(v_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t bv = desc(v_s + s * C::kTileBytes + kk * 16 * C::kRowBytes,
                               C::kKVPanelBytes, 8 * C::kRowBytes, C::kLayout);
      wgmma_rs<DH>(pv, hi[kk], bv, kk > 0);
      wgmma_rs<DH>(pv, mid[kk], bv, 1);
      wgmma_rs<DH>(pv, lo[kk], bv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    if (lane == 0) mbar_arrive(v_empty(s));

    // acc = acc * corr + p.v in fp32 on the CUDA cores
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[4 * c + e] = acc[4 * c + e] * corr[e >> 1] + pv[4 * c + e];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int pos = row0 + 8 * r;
    if (pos >= sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
    __nv_bfloat16* out =
        o + ((static_cast<int64_t>(b) * sq + pos) * heads + h) * DH + col;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[4 * c + 2 * r] / den, acc[4 * c + 2 * r + 1] / den);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point lookup, so the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (batch, rows, width) bf16 rows in one map; a box is `box_rows` rows of
// one panel, swizzled at the panel's width. Out-of-bounds rows read as 0.
template <int DH>
int encode(CUtensorMap* map, const void* ptr, int64_t batch, int64_t rows,
           int64_t width, int box_rows) {
  using C = Cfg<DH>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoTensorMapEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width * 2),
                                 static_cast<cuuint64_t>(width * rows * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kPanel),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapRefused;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t sq, int64_t skv, int64_t heads,
           int64_t kv_heads, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap q_map, k_map, v_map;
  int err = encode<DH>(&q_map, q, batch, sq, heads * DH, kBlockM);
  if (err == 0) err = encode<DH>(&k_map, k, batch, skv, kv_heads * DH, kBlockN);
  if (err == 0) err = encode<DH>(&v_map, v, batch, skv, kv_heads * DH, kBlockN);
  if (err != 0) return err;
  const auto kernel = flash_attention_kernel<DH>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(heads),
                  static_cast<unsigned>((sq + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
      static_cast<int>(sq), static_cast<int>(skv), static_cast<int>(heads),
      static_cast<int>(kv_heads), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <typename F>
int by_head_dim(int64_t dh, F&& launch) {
  switch (dh) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 96: return launch(std::integral_constant<int, 96>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int64_t batch,
                                   int64_t sq, int64_t skv, int64_t heads,
                                   int64_t kv_heads, int64_t dh, float scale,
                                   int causal, void* stream) {
  return by_head_dim(dh, [&](auto d) {
    return f32::launch<decltype(d)::value>(
        q, k, v, o, batch, sq, skv, heads, kv_heads, scale, causal,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int64_t batch,
                                    int64_t sq, int64_t skv, int64_t heads,
                                    int64_t kv_heads, int64_t dh, float scale,
                                    int causal, void* stream) {
  return by_head_dim(dh, [&](auto d) {
    return wg::launch<decltype(d)::value>(
        q, k, v, o, batch, sq, skv, heads, kv_heads, scale, causal,
        static_cast<cudaStream_t>(stream));
  });
}
