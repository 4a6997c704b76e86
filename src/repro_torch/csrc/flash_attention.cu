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
// kernel's tiles are 64 keys where they are 128, which changes only the
// fp32 rounding (an online softmax is exact over any tiling).
//
// Bound on an H100: operations. A causal prefill of S tokens does
// 4 * B * H * dh * S(S+1)/2 flops (8.8e12 a qwen3-4b layer at 32k) and
// reads q, k, v once (0.4 GB), so the bf16 tensor-core peak bounds it.
// This first design keeps p in fp32 as the contract says: q.k^T runs on
// the tensor cores for bf16 inputs (mma.sync m16n8k16, bf16 products are
// exact in fp32 and summed in fp32); p.v runs in fp32 on the CUDA cores,
// so it caps the kernel at the fp32 FMA rate, well above the bound.
//
// Design. One CTA of 4 warps per (b, h, 64-query tile); the tiles are
// issued longest-first (causal tile i walks i+1 kv tiles). q/k/v are read
// strided straight from (B, S, H|KV, dh), no transposes or padding
// copies. Each warp owns 16 query rows. Per kv tile of 64 keys, K (in the
// input type) and V (converted to fp32) are staged in shared memory; the
// warp's 16x64 scores sit in registers in the mma accumulator layout (lane
// = 4 * group + quad: rows group and group+8, 16 keys each), so each row's
// max and sum are a register pass and two xor-shuffles across the quad.
// For p.v each lane keeps rows group and group+8 of the fp32 output at 32
// columns (dh 128): every key's two p values are shuffled from the quad
// lane that holds them and multiplied into float4 rows of V. kv tiles
// wholly above the diagonal are not visited. fp32 inputs take the same
// path with q.k^T on the CUDA cores (for checks; the LM serves in bf16).
// Registers and spills: nvcc -Xptxas -v (numbers in PERF.md).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;  // queries per CTA, and keys per staged tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Row strides in shared memory, padded by 16 bytes so the 8 rows a
// fragment load touches fall on distinct banks.
template <typename T, int DH>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kStride = DH + kPad;  // Q and K rows, in T
  static constexpr size_t kQBytes = sizeof(T) * kTile * kStride;
  static constexpr size_t kKBytes = sizeof(T) * kTile * kStride;
  static constexpr size_t kVBytes = sizeof(float) * kTile * DH;
  static constexpr size_t kBytes = kQBytes + kKBytes + kVBytes;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy kTile rows of DH elements (row r at src + r * src_stride) into
// shared memory, rows past `valid` as zeros. kToFloat converts to fp32
// (V); otherwise the row keeps its type and the padded stride (Q, K).
template <typename T, int DH, bool kToFloat>
__device__ __forceinline__ void stage_rows(void* dst, const T* src,
                                           int64_t src_stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) {
      raw = *reinterpret_cast<const uint4*>(src + row * src_stride + col);
    }
    if constexpr (kToFloat) {
      float* out = static_cast<float*>(dst) + row * DH + col;
      if constexpr (sizeof(T) == 2) {
        const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float2 f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
        reinterpret_cast<float4*>(out)[0] =
            make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
        reinterpret_cast<float4*>(out)[1] =
            make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
      } else {
        *reinterpret_cast<uint4*>(out) = raw;
      }
    } else {
      T* out = static_cast<T*>(dst) + row * Smem<T, DH>::kStride + col;
      *reinterpret_cast<uint4*>(out) = raw;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int64_t sq, int64_t skv, int64_t heads,
                           int64_t kv_heads, float scale, int causal) {
  using S = Smem<T, DH>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kCols = DH / 4;  // output columns a lane keeps per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + S::kQBytes);
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
  const T* q_base = q + ((b * sq + q0) * heads + h) * DH;
  const T* k_base = k + (b * skv * kv_heads + kvh) * DH;
  const T* v_base = v + (b * skv * kv_heads + kvh) * DH;

  stage_rows<T, DH, false>(qs, q_base, q_stride,
                           static_cast<int>(imin(kTile, sq - q0)));
  __syncthreads();

  const int r0 = warp * 16 + group;  // this lane's rows: r0 and r0 + 8
  const int64_t qpos0 = q0 + r0;
  const int64_t qpos1 = qpos0 + 8;
  uint32_t qf[kBf16 ? DH / 16 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const T* a = qs + r0 * S::kStride + kk * 16 + quad * 2;
      qf[kk][0] = ld32(a);
      qf[kk][1] = ld32(a + 8 * S::kStride);
      qf[kk][2] = ld32(a + 8);
      qf[kk][3] = ld32(a + 8 * S::kStride + 8);
    }
  }

  float acc[2][kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[0][c] = acc[1][c] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.0f, 0.0f};

  int64_t kv_end = skv;
  if (causal) kv_end = imin(skv, q0 + kTile);  // keys <= last row
  for (int64_t kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    const int valid = static_cast<int>(imin(kTile, skv - kv0));
    __syncthreads();  // the previous tile's K/V are no longer read
    stage_rows<T, DH, false>(ks, k_base + kv0 * kv_stride, kv_stride, valid);
    stage_rows<T, DH, true>(vs, v_base + kv0 * kv_stride, kv_stride, valid);
    __syncthreads();

    // s[t][0..1]: row r0, keys t*8 + quad*2 + {0,1}; s[t][2..3]: row r0+8
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
    if constexpr (kBf16) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const T* kr = ks + (t * 8 + group) * S::kStride + quad * 2;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          mma_bf16(s[t], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
        }
      }
    } else {
      const float* qa = reinterpret_cast<const float*>(qs) + r0 * S::kStride;
      const float* qb = qa + 8 * S::kStride;
      const float* kb = reinterpret_cast<const float*>(ks) + quad * 2 * S::kStride;
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
    T* out = o + ((b * sq + pos) * heads + h) * DH + quad * 4;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[j * 16 + i] = from_f32<T>(acc[r][4 * j + i] / den);
      }
    }
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              int64_t batch, int64_t sq, int64_t skv, int64_t heads,
              int64_t kv_heads, float scale, int causal,
              cudaStream_t stream) {
  const auto kernel = flash_attention_kernel<T, DH>;
  const size_t smem = Smem<T, DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kTile - 1) / kTile),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, heads, kv_heads,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t sq, int64_t skv, int64_t heads,
           int64_t kv_heads, int64_t dh, float scale, int causal,
           void* stream_v) {
  const auto stream = static_cast<cudaStream_t>(stream_v);
  switch (dh) {
    case 16:
      return launch_dh<T, 16>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                              scale, causal, stream);
    case 32:
      return launch_dh<T, 32>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                              scale, causal, stream);
    case 64:
      return launch_dh<T, 64>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                              scale, causal, stream);
    case 96:
      return launch_dh<T, 96>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                              scale, causal, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                               scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int64_t batch,
                                   int64_t sq, int64_t skv, int64_t heads,
                                   int64_t kv_heads, int64_t dh, float scale,
                                   int causal, void* stream) {
  return launch<float>(q, k, v, o, batch, sq, skv, heads, kv_heads, dh,
                       scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int64_t batch,
                                    int64_t sq, int64_t skv, int64_t heads,
                                    int64_t kv_heads, int64_t dh, float scale,
                                    int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                               dh, scale, causal, stream);
}
