// Paged attention for Hopper (sm_90a): one-token flash decode and chunked
// (multi-query) prefill through the block table, with the GRAU epilogue
// optionally fused.
//
// Replaces: the JAX package's kernels/paged_attention.py
//   * _paged_attention_jit (via paged_attention)        -> paged_decode_kernel
//   * _paged_prefill_jit (via paged_prefill_attention)  -> paged_prefill_kernel
// both with the fused grau_datapath epilogue (grau_datapath.cuh).
//
// What it computes: for batch row b and KV head kh, the query rows that
// share kh — g = h / kvh heads for decode, C * g (chunk row, head) rows for
// prefill — attend pool positions through table[b, :]: row (c, gi) sees
// positions <= start[b] + c (decode: start = length - 1, C = 1). Online
// softmax in f32 with NEG_INF = -1e30 (finite) and a 1e-30 floor on the
// normaliser, so an idle slot (length 0) still reads block table[b, 0] and
// stays finite. With the epilogue the f32 output is scaled by inv_s,
// rounded half to even with saturation (__float2int_rn; NaN -> 0) and
// pushed through the GRAU datapath, emitting one byte per element.
//
// Bound on the H100: memory bytes. Decode reads each live KV block once
// per (slot, KV head) for 2 * g * d flops per position — about 3 flops per
// byte at g = 3 in bf16, far below the ~295 at which the tensor cores would
// bind. Prefill at C = 32 does 32x the flops on the same bytes, still below
// the line. Design (simple and right first): one CUDA block of 128 threads
// per (row tile of 16 query rows, KV head, batch row); the TPU's sequential
// block axis with its (m, l, acc) carry becomes a loop inside the block over
// the live blocks only (never past cdiv(start + last row + 1, bs), never past
// the table width), so HBM traffic follows live tokens. Each loop step
// stages at least 64 positions (whole pool blocks, through the table) of K
// and V in shared memory as f32 with 16-byte loads — enough bytes in flight
// per step to amortise the load latency — and all the tile's query rows
// read them there (K rows padded by one word against bank conflicts). The
// softmax update runs one warp per row; the accumulator lives in registers,
// 16 * d / 128 values a thread. No tensor cores, TMA or split over the
// sequence yet: decode at 8 slots fills only 64 of the 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grau_datapath.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr int kMinTile = 64;
constexpr float kNegInf = -1e30f;

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutGrau = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Epilogue {
  const int32_t* regs;   // GRAU register file (global), or null
  int num_exponents, qmin, qmax;
  float inv_s;
};

// Positions staged per loop step: whole pool blocks, at least kMinTile
// positions (so one step moves enough bytes to hide load latency).
inline int tile_blocks(int bs) { return bs >= kMinTile ? 1 : kMinTile / bs; }

inline size_t smem_bytes(int d, int bs) {
  const size_t P = (size_t)tile_blocks(bs) * bs;
  return sizeof(float) * ((size_t)kRowTile * d + P * (d + 1) + P * d +
                          (size_t)kRowTile * P + 3 * kRowTile) +
         sizeof(int32_t) * (GRAU_REG_WORDS + tile_blocks(bs));
}

// 16 bytes of K or V -> f32: 4 floats, or 8 bf16 values.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// One CUDA block: query rows [r0, r0 + kRowTile) of the C * g rows that
// share KV head kh in batch row b. Each loop step stages NB = tile_blocks
// consecutive table blocks (P = NB * bs positions) of K and V.
template <typename T, int D>
__device__ void attend_rows(const T* __restrict__ q, const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int32_t* __restrict__ table, int table_stride,
                            int start, void* __restrict__ out, int b, int C,
                            int h, int kvh, int bs, int nblocks, float scale,
                            int out_kind, Epilogue epi) {
  constexpr int kPer = kRowTile * D / kThreads;   // accumulator words/thread
  constexpr int kVec = 16 / sizeof(T);            // elements per 16-byte load
  constexpr int kWarps = kThreads / 32;
  const int NB = bs >= kMinTile ? 1 : kMinTile / bs;
  const int P = NB * bs;
  extern __shared__ float smem[];
  float* qs = smem;                               // kRowTile x D
  float* ks = qs + kRowTile * D;                  // P x (D + 1)
  float* vs = ks + P * (D + 1);                   // P x D
  float* ps = vs + P * D;                         // kRowTile x P
  float* m_s = ps + kRowTile * P;                 // kRowTile
  float* l_s = m_s + kRowTile;
  float* a_s = l_s + kRowTile;
  int32_t* regs = reinterpret_cast<int32_t*>(a_s + kRowTile);
  int32_t* blk_s = regs + GRAU_REG_WORDS;         // NB pool block ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float kDead = __int_as_float(0xff800000);   // -inf
  const int kh = blockIdx.y;
  const int g = h / kvh;
  const int rows = C * g;
  const int r0 = blockIdx.x * kRowTile;

  for (int idx = tid; idx < kRowTile * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D, row = r0 + r;
    float val = 0.f;
    if (row < rows) {
      const int c = row / g, gi = row % g;
      val = to_f32(q[(((size_t)b * C + c) * h + kh * g + gi) * D + dd]);
    }
    qs[idx] = val;
  }
  if (tid < kRowTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if (out_kind == kOutGrau && tid < GRAU_REG_WORDS) regs[tid] = epi.regs[tid];

  // live blocks for this tile: its last row attends start + c_last; blocks
  // past that are fully masked for every row of the tile (p = 0 exactly)
  const int row_last = min(r0 + kRowTile, rows) - 1;
  const int c_last = row_last / g;
  int live = (start + c_last + 1 + bs - 1) / bs;
  live = live < 1 ? 1 : live;
  live = live > nblocks ? nblocks : live;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  const size_t pos_stride = (size_t)kvh * D;
  for (int j0 = 0; j0 < live; j0 += NB) {
    __syncthreads();   // previous tile fully consumed
    if (tid < NB)
      blk_s[tid] = j0 + tid < live ? table[(size_t)b * table_stride + j0 + tid]
                                   : -1;
    __syncthreads();
    for (int idx = tid; idx < P * (D / kVec); idx += kThreads) {
      const int t = idx / (D / kVec), dd = (idx % (D / kVec)) * kVec;
      const int blk = blk_s[t / bs];
      float kf[kVec], vf[kVec];
      if (blk >= 0) {
        const size_t src = ((size_t)blk * bs + t % bs) * pos_stride +
                           (size_t)kh * D + dd;
        load16(k_pool + src, kf);
        load16(v_pool + src, vf);
      } else {   // past the live blocks: never read, never weighted
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[t * (D + 1) + dd + e] = kf[e];
        vs[t * D + dd + e] = vf[e];
      }
    }
    __syncthreads();
    // logits: NEG_INF (finite, as the reference) where the causal/length
    // mask hides a live position; -inf past the live blocks, so those
    // weigh exactly 0 even in a row with no visible position (idle slot)
    for (int idx = tid; idx < kRowTile * P; idx += kThreads) {
      const int r = idx / P, t = idx % P, row = r0 + r;
      float lg = kDead;
      if (blk_s[t / bs] >= 0) {
        lg = kNegInf;
        if (row < rows && (j0 * bs + t) <= start + row / g) {
          const float* qr = qs + r * D;
          const float* kr = ks + t * (D + 1);
          float dot = 0.f;
#pragma unroll 8
          for (int dd = 0; dd < D; ++dd) dot += qr[dd] * kr[dd];
          lg = dot * scale;
        }
      }
      ps[idx] = lg;
    }
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < kRowTile; r += kWarps) {
      float* pr = ps + r * P;
      float mx = kDead;
      for (int t = lane; t < P; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < P; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, r = e / D, dd = e % D;
      if (r0 + r >= rows) continue;             // padding row (warp-uniform)
      const float* pr = ps + r * P;
      float s = 0.f;
      for (int t = 0; t < P; ++t) s += pr[t] * vs[t * D + dd];
      acc[i] = acc[i] * a_s[r] + s;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads, r = e / D, dd = e % D, row = r0 + r;
    if (row >= rows) continue;
    const int c = row / g, gi = row % g;
    const size_t off = (((size_t)b * C + c) * h + kh * g + gi) * D + dd;
    const float o = acc[i] / fmaxf(l_s[r], 1e-30f);
    if (out_kind == kOutF32) {
      reinterpret_cast<float*>(out)[off] = o;
    } else if (out_kind == kOutBF16) {
      reinterpret_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(o);
    } else {
      const int32_t xq = __float2int_rn(o * epi.inv_s);
      reinterpret_cast<uint8_t*>(out)[off] = (uint8_t)grau_datapath(
          xq, regs, epi.num_exponents, epi.qmin, epi.qmax);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* q, const T* k_pool, const T* v_pool,
                    const int32_t* table, int table_stride,
                    const int32_t* lengths, void* out, int h, int kvh, int bs,
                    int nblocks, float scale, int out_kind, Epilogue epi) {
  const int b = blockIdx.z;
  attend_rows<T, D>(q, k_pool, v_pool, table, table_stride, lengths[b] - 1,
                    out, b, 1, h, kvh, bs, nblocks, scale, out_kind, epi);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* q, const T* k_pool, const T* v_pool,
                     const int32_t* table, int table_stride,
                     const int32_t* starts, void* out, int C, int h, int kvh,
                     int bs, int nblocks, float scale, int out_kind,
                     Epilogue epi) {
  const int b = blockIdx.z;
  attend_rows<T, D>(q, k_pool, v_pool, table, table_stride, starts[b], out, b,
                    C, h, kvh, bs, nblocks, scale, out_kind, epi);
}

template <typename T, int D>
int launch(bool decode, const void* q, const void* k_pool, const void* v_pool,
           const void* table, int table_stride, const void* start, void* out,
           int batch, int C, int h, int kvh, int bs, int nblocks, float scale,
           int out_kind, Epilogue epi, cudaStream_t stream) {
  const int rows = C * (h / kvh);
  const dim3 grid((rows + kRowTile - 1) / kRowTile, kvh, batch);
  const size_t smem = smem_bytes(D, bs);
  if (decode) {
    auto kern = paged_decode_kernel<T, D>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kern<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool,
        (const int32_t*)table, table_stride, (const int32_t*)start, out, h,
        kvh, bs, nblocks, scale, out_kind, epi);
  } else {
    auto kern = paged_prefill_kernel<T, D>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kern<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool,
        (const int32_t*)table, table_stride, (const int32_t*)start, out, C, h,
        kvh, bs, nblocks, scale, out_kind, epi);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(bool decode, int d, const void* q, const void* k_pool,
               const void* v_pool, const void* table, int table_stride,
               const void* start, void* out, int batch, int C, int h, int kvh,
               int bs, int nblocks, float scale, int out_kind, Epilogue epi,
               cudaStream_t stream) {
#define PA_CASE(DV)                                                          \
  case DV:                                                                   \
    return launch<T, DV>(decode, q, k_pool, v_pool, table, table_stride,     \
                         start, out, batch, C, h, kvh, bs, nblocks, scale,   \
                         out_kind, epi, stream);
  switch (d) {
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
    PA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

int dispatch(bool decode, int dtype, int d, const void* q, const void* k_pool,
             const void* v_pool, const void* table, int table_stride,
             const void* start, void* out, int batch, int C, int h, int kvh,
             int bs, int nblocks, float scale, int out_kind, const void* regs,
             int num_exponents, int qmin, int qmax, float inv_s,
             void* stream) {
  if (batch <= 0) return 0;
  if (nblocks < 1 || kvh < 1 || h % kvh != 0 || bs < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (out_kind == kOutGrau && regs == nullptr) return (int)cudaErrorInvalidValue;
  const Epilogue epi{(const int32_t*)regs, num_exponents, qmin, qmax, inv_s};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(decode, d, q, k_pool, v_pool, table, table_stride,
                             start, out, batch, C, h, kvh, bs, nblocks, scale,
                             out_kind, epi, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(decode, d, q, k_pool, v_pool, table,
                                     table_stride, start, out, batch, C, h,
                                     kvh, bs, nblocks, scale, out_kind, epi,
                                     st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q and pools). out_kind: 0 = f32, 1 = bf16,
// 2 = GRAU byte (int8 or uint8). regs: GRAU register file (out_kind 2).
extern "C" int paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    int table_stride, const void* lengths, void* out, int slots, int h,
    int kvh, int d, int bs, int nblocks, float scale, int dtype, int out_kind,
    const void* regs, int num_exponents, int qmin, int qmax, float inv_s,
    void* stream) {
  return dispatch(true, dtype, d, q, k_pool, v_pool, table, table_stride,
                  lengths, out, slots, 1, h, kvh, bs, nblocks, scale, out_kind,
                  regs, num_exponents, qmin, qmax, inv_s, stream);
}

extern "C" int paged_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    int table_stride, const void* starts, void* out, int batch, int chunk,
    int h, int kvh, int d, int bs, int nblocks, float scale, int dtype,
    int out_kind, const void* regs, int num_exponents, int qmin, int qmax,
    float inv_s, void* stream) {
  return dispatch(false, dtype, d, q, k_pool, v_pool, table, table_stride,
                  starts, out, batch, chunk, h, kvh, bs, nblocks, scale,
                  out_kind, regs, num_exponents, qmin, qmax, inv_s, stream);
}
