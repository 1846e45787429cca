// Paged attention for Hopper (sm_90a) on f32 queries: one-token flash
// decode and chunked (multi-query) prefill through the block table, with
// the GRAU epilogue optionally fused.
//
// Replaces: the JAX package's kernels/paged_attention.py, for f32 queries
// (f32 pools, or 8-/4-bit pools):
//   * _paged_attention_jit (via paged_attention)        -> paged_decode_kernel
//   * _paged_prefill_jit (via paged_prefill_attention)  -> paged_prefill_kernel
// both with the fused grau_datapath epilogue (grau_datapath.cuh). bf16
// queries, the served dtype, go to paged_prefill.cu's tensor-core kernels,
// split over the sequence (the wrapper dispatches by dtype, not on
// failure).
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
// per (slot, KV head) for 2 * g * d flops per position — about 1.5 flops
// per f32 byte at g = 3, far below the ~295 at which the tensor cores would
// bind. Prefill at C = 32 does 32x the flops on the same bytes, still below
// the line. Design (simple and right first: f32 is the CPU-parity dtype,
// not the served one): one CUDA block of 128 threads per (row tile of 16
// query rows, KV head, batch row); the TPU's sequential block axis with its
// (m, l, acc) carry becomes a loop inside the block over the live blocks
// only (never past cdiv(start + last row + 1, bs), never past the table
// width), so HBM traffic follows live tokens. Each loop step stages at
// least 64 positions (whole pool blocks, through the table) of K and V in
// shared memory as f32 with 16-byte loads (8-byte ones where a 4-bit row is
// not whole 16-byte vectors: 8 and 24 bytes at head_dim 16 and 48), and all
// the tile's query rows read them there (K rows padded by one word against
// bank conflicts). The softmax update runs one warp per row; the
// accumulator lives in registers, 16 * d / 128 values a thread, on the FMA
// units in f32 throughout.
//
// Quantized pools (kv_bits 8 / 4; replaces the kv_bits < 16 branch of the
// reference's _dequant_tile, used by both kernels through _attend_block /
// _attend_block_mq): the pools hold int8 words, (nb, bs, kvh, d) at 8 bits
// or (nb, bs, kvh, d/2) at 4 bits — byte i of a position row holds head-dim
// element i in its low nibble and i + d/2 in its high nibble — and each
// (block, kv head) carries one int8 exponent per tensor. The loaders
// dequantize at load, into the same f32 staging: the block's 2^e is built
// by bits (__int_as_float((e + 127) << 23)) once per block and loop step,
// and one vector load of a 4-bit row yields two values a byte, written to
// two places in shared memory. Dequantized values are exact in f32, so the
// recurrence after the load is the 16-bit one, and the bytes the kernel
// moves follow kv_bits. A never-written block has exponent -126, a normal
// 2^e, so the idle slot's null-block read stays finite. Head dims: any
// multiple of 16, instantiated for 16, 32, 48, 64, 128, 192 and 256.
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
// pool storage: 16-bit pools hold f32 (q's type); quantized pools int8
enum PoolKind { kPoolF32 = 0, kPoolQ8 = 2, kPoolQ4 = 3 };

// bytes of one (position, kv head) row of a pool of kind KIND
template <int KIND, int D>
__host__ __device__ constexpr int row_bytes() {
  return KIND == kPoolF32 ? 4 * D : KIND == kPoolQ8 ? D : D / 2;
}
// bytes a staging load: 16, or 8 where a row is not whole 16-byte vectors
template <int KIND, int D>
__host__ __device__ constexpr int vec_bytes() {
  return row_bytes<KIND, D>() % 16 == 0 ? 16 : 8;
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
                          (size_t)kRowTile * P + 3 * kRowTile +
                          2 * tile_blocks(bs)) +
         sizeof(int32_t) * (GRAU_REG_WORDS + tile_blocks(bs));
}

__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// word w of a staging vector held in registers
__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Load vector li (VEC = vec_bytes bytes) of a pool row and write its
// values, as f32, into the staged row `dst` (scale: the block's 2^e; 1 for
// f32 pools): 4 floats, 16 int8 values, or 2 VEC int4 values of which the
// low nibbles are elements VEC*li + i and the high ones d/2 + VEC*li + i.
template <int KIND, int D>
__device__ __forceinline__ void stage_vec(const uint8_t* row, int li,
                                          float scale, float* dst) {
  constexpr int VEC = vec_bytes<KIND, D>();
  uint4 v;
  if constexpr (VEC == 16) {
    v = *reinterpret_cast<const uint4*>(row + 16 * li);
  } else {
    const uint2 h = *reinterpret_cast<const uint2*>(row + 8 * li);
    v = make_uint4(h.x, h.y, 0u, 0u);
  }
  if constexpr (KIND == kPoolF32) {
#pragma unroll
    for (int w = 0; w < 4; ++w) dst[4 * li + w] = __uint_as_float(word_of(v, w));
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const int8_t b = (int8_t)(word_of(v, c >> 2) >> (8 * (c & 3)));
      if constexpr (KIND == kPoolQ8) {
        dst[VEC * li + c] = (float)b * scale;
      } else {
        const int8_t lo = (int8_t)((uint8_t)b << 4) >> 4;
        const int8_t hi = b >> 4;
        dst[VEC * li + c] = (float)lo * scale;
        dst[D / 2 + VEC * li + c] = (float)hi * scale;
      }
    }
  }
}

// The K/V pools of one launch: payloads as bytes, and for quantized pools
// the (num_blocks, kvh) int8 exponent planes (null for 16-bit pools).
struct Pools {
  const uint8_t* k;
  const uint8_t* v;
  const int8_t* k_exp;
  const int8_t* v_exp;
};

// One CUDA block: query rows [r0, r0 + kRowTile) of the C * g rows that
// share KV head kh in batch row b. Each loop step stages NB = tile_blocks
// consecutive table blocks (P = NB * bs positions) of K and V.
template <int KIND, int D>
__device__ void attend_rows(const float* __restrict__ q, Pools pools,
                            const int32_t* __restrict__ table, int table_stride,
                            int start, void* __restrict__ out, int b, int C,
                            int h, int kvh, int bs, int nblocks, float scale,
                            int out_kind, Epilogue epi) {
  constexpr int kPer = kRowTile * D / kThreads;   // accumulator words/thread
  constexpr int kRow = row_bytes<KIND, D>();
  constexpr int kLoads = kRow / vec_bytes<KIND, D>();   // loads per row
  constexpr bool kQuant = KIND == kPoolQ8 || KIND == kPoolQ4;
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
  float* kscale_s = a_s + kRowTile;              // NB: 2^e of K per block
  float* vscale_s = kscale_s + NB;                // NB: 2^e of V per block
  int32_t* regs = reinterpret_cast<int32_t*>(vscale_s + NB);
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
      val = q[(((size_t)b * C + c) * h + kh * g + gi) * D + dd];
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

  for (int j0 = 0; j0 < live; j0 += NB) {
    __syncthreads();   // previous tile fully consumed
    if (tid < NB) {
      const int blk = j0 + tid < live
                          ? table[(size_t)b * table_stride + j0 + tid] : -1;
      blk_s[tid] = blk;
      kscale_s[tid] = vscale_s[tid] = 1.f;
      if (kQuant && blk >= 0) {   // the block's exponent, read once
        kscale_s[tid] = exp2i(pools.k_exp[(size_t)blk * kvh + kh]);
        vscale_s[tid] = exp2i(pools.v_exp[(size_t)blk * kvh + kh]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < P * kLoads; idx += kThreads) {
      const int t = idx / kLoads, li = idx % kLoads;
      const int blk = blk_s[t / bs];
      float* krow = ks + t * (D + 1);
      float* vrow = vs + t * D;
      if (blk >= 0) {
        const size_t src = (((size_t)blk * bs + t % bs) * kvh + kh) * kRow;
        stage_vec<KIND, D>(pools.k + src, li, kscale_s[t / bs], krow);
        stage_vec<KIND, D>(pools.v + src, li, vscale_s[t / bs], vrow);
      } else {   // past the live blocks: never read, never weighted
        constexpr int kElems = D / kLoads;     // elements one load covers
        constexpr int kSpan = KIND == kPoolQ4 ? kElems / 2 : kElems;
#pragma unroll
        for (int e = 0; e < kSpan; ++e) {
          krow[li * kSpan + e] = vrow[li * kSpan + e] = 0.f;
          if (KIND == kPoolQ4)
            krow[D / 2 + li * kSpan + e] = vrow[D / 2 + li * kSpan + e] = 0.f;
        }
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

template <int KIND, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* q, Pools pools, const int32_t* table,
                    int table_stride, const int32_t* lengths, void* out, int h,
                    int kvh, int bs, int nblocks, float scale, int out_kind,
                    Epilogue epi) {
  const int b = blockIdx.z;
  attend_rows<KIND, D>(q, pools, table, table_stride, lengths[b] - 1, out, b,
                       1, h, kvh, bs, nblocks, scale, out_kind, epi);
}

template <int KIND, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const float* q, Pools pools, const int32_t* table,
                     int table_stride, const int32_t* starts, void* out, int C,
                     int h, int kvh, int bs, int nblocks, float scale,
                     int out_kind, Epilogue epi) {
  const int b = blockIdx.z;
  attend_rows<KIND, D>(q, pools, table, table_stride, starts[b], out, b, C,
                       h, kvh, bs, nblocks, scale, out_kind, epi);
}

// Everything one launch needs besides the compile-time choices.
struct Args {
  bool decode;
  const void* q;
  Pools pools;
  const int32_t* table;
  int table_stride;
  const int32_t* start;   // lengths (decode) or chunk starts (prefill)
  void* out;
  int batch, C, h, kvh, bs, nblocks;
  float scale;
  int out_kind;
  Epilogue epi;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int KIND, int D>
int launch(const Args& a) {
  const int rows = a.C * (a.h / a.kvh);
  const dim3 grid((rows + kRowTile - 1) / kRowTile, a.kvh, a.batch);
  const size_t smem = smem_bytes(D, a.bs);
  const float* q = (const float*)a.q;
  cudaError_t err;
  if (a.decode) {
    auto kern = paged_decode_kernel<KIND, D>;
    err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        q, a.pools, a.table, a.table_stride, a.start, a.out, a.h, a.kvh, a.bs,
        a.nblocks, a.scale, a.out_kind, a.epi);
  } else {
    auto kern = paged_prefill_kernel<KIND, D>;
    err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        q, a.pools, a.table, a.table_stride, a.start, a.out, a.C, a.h, a.kvh,
        a.bs, a.nblocks, a.scale, a.out_kind, a.epi);
  }
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<KIND, 16>(a);
    case 32: return launch<KIND, 32>(a);
    case 48: return launch<KIND, 48>(a);
    case 64: return launch<KIND, 64>(a);
    case 128: return launch<KIND, 128>(a);
    case 192: return launch<KIND, 192>(a);
    case 256: return launch<KIND, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Args a, int dtype, int d, int kv_bits, const void* regs,
             int num_exponents, int qmin, int qmax, float inv_s) {
  if (a.batch <= 0) return 0;
  if (a.nblocks < 1 || a.kvh < 1 || a.h % a.kvh != 0 || a.bs < 1 || a.C < 1)
    return (int)cudaErrorInvalidValue;
  if (a.out_kind == kOutGrau && regs == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kv_bits != 16 && (a.pools.k_exp == nullptr || a.pools.v_exp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0) return (int)cudaErrorInvalidValue;   // bf16: paged_prefill.cu
  a.epi = Epilogue{(const int32_t*)regs, num_exponents, qmin, qmax, inv_s};
  if (kv_bits == 16) return dispatch_d<kPoolF32>(d, a);
  if (kv_bits == 8) return dispatch_d<kPoolQ8>(d, a);
  if (kv_bits == 4) return dispatch_d<kPoolQ4>(d, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32 (q, and the pools at kv_bits 16); bf16 q is
// paged_prefill.cu's, and dtype 1 is refused. kv_bits 8 / 4:
// int8 pools of width d / d/2 with (num_blocks, kvh) int8 exponent planes
// k_exp / v_exp (null at 16). out_kind: 0 = f32, 1 = bf16, 2 = GRAU byte
// (int8 or uint8). regs: GRAU register file (out_kind 2).
extern "C" int paged_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_exp,
    const void* v_exp, int kv_bits, const void* table, int table_stride,
    const void* lengths, void* out, int slots, int h, int kvh, int d, int bs,
    int nblocks, float scale, int dtype, int out_kind, const void* regs,
    int num_exponents, int qmin, int qmax, float inv_s, void* stream) {
  const Args a{true, q,
               Pools{(const uint8_t*)k_pool, (const uint8_t*)v_pool,
                     (const int8_t*)k_exp, (const int8_t*)v_exp},
               (const int32_t*)table, table_stride, (const int32_t*)lengths,
               out, slots, 1, h, kvh, bs, nblocks, scale, out_kind,
               Epilogue{}, (cudaStream_t)stream};
  return dispatch(a, dtype, d, kv_bits, regs, num_exponents, qmin, qmax,
                  inv_s);
}

extern "C" int paged_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_exp,
    const void* v_exp, int kv_bits, const void* table, int table_stride,
    const void* starts, void* out, int batch, int chunk, int h, int kvh, int d,
    int bs, int nblocks, float scale, int dtype, int out_kind,
    const void* regs, int num_exponents, int qmin, int qmax, float inv_s,
    void* stream) {
  const Args a{false, q,
               Pools{(const uint8_t*)k_pool, (const uint8_t*)v_pool,
                     (const int8_t*)k_exp, (const int8_t*)v_exp},
               (const int32_t*)table, table_stride, (const int32_t*)starts,
               out, batch, chunk, h, kvh, bs, nblocks, scale, out_kind,
               Epilogue{}, (cudaStream_t)stream};
  return dispatch(a, dtype, d, kv_bits, regs, num_exponents, qmin, qmax,
                  inv_s);
}
