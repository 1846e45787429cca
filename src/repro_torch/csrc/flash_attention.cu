// Dense GQA flash attention forward for Hopper (sm_90a), causal or not: the
// attention of LM training (nn/attention.chunked_attention on the card).
//
// Replaces: the JAX package's kernels/flash_attention.py::flash_attention
// (body _flash_kernel).
//
// What it computes: for batch row b and query head hi, reading KV head
// hi / (h / kvh), row r of q (query position q_offset + r) attends key
// positions j < s_kv (causal: j <= q_offset + r):
//   s = scale * q_r . k_j, masked scores -1e30 (finite, as the reference);
//   o_r = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30), m = max s;
//   lse_r = m + log(sum_j exp(s_j - m))   (f32; the backward's P = exp(S - lse)).
// q (b, s_q, h, d), k and v (b, s_kv, kvh, d) are read through their strides
// (the last dimension contiguous), so no transpose copy is made; o is
// written contiguous (b, s_q, h, d) in q's dtype, lse as (b, h, s_q) f32.
// Key tiles are visited in increasing order and tile 0 always holds key 0,
// which every row may attend (q_offset >= 0): after the first tile each
// row's running max is a real score, so masked entries add exp(-1e30 - m)
// = 0 and the -1e30 convention never mixes into a live row. Ragged s_q and
// s_kv are masked here (rows past s_q are not stored, keys past s_kv are
// masked and staged as zeros); nothing depends on the reference's 512-row
// VMEM blocks. Tiles wholly above the diagonal are never loaded.
//
// Bound on the H100: operations. At the training shape (1, 4096, 24, 128)
// over 8 KV heads, causal, the products are 4 * 24 * 4096^2 * 128 / 2 =
// 103 GFLOP (0.104 ms at 989 TFLOP/s bf16) against 50 MB of q, k, v and o
// (0.015 ms at 3.35 TB/s).
//
// Design (right and simple first; wgmma, TMA and warp specialisation are
// for the PR that makes it fast):
//   * bf16: one block of 4 warps per (64 query rows, batch row x head); each
//     warp owns 16 rows. Q, and K and V tiles of 64 keys, are staged in
//     shared memory by cp.async (K/V double-buffered: the next tile's copy
//     runs under this tile's products), rows padded by 16 bytes so that the
//     fragment reads are conflict-free. S = Q K^T and O += P V on the bf16
//     tensor cores (mma.sync m16n8k16, f32 accumulators); V's B fragments
//     come from ldmatrix.trans. The online softmax runs in f32 registers;
//     P is rounded to bf16 before P V (its row sum l stays f32). Query
//     tiles are issued heaviest first (the last causal tile first).
//   * f32: computed in f32 on the FMA units (no TF32): one block of 4 warps
//     per (16 query rows, batch row x head), K/V tiles of 32 keys in shared
//     memory; a warp walks its 4 rows, lane j scoring key j, and each lane
//     accumulates d / 32 output columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, sq, skv, h, kvh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal, q_offset;
};

// Keys [0, kv_end) that some row of query rows [q0, q0 + rows) may attend.
__device__ __forceinline__ int kv_limit(const Params& p, int q0, int rows) {
  int end = p.skv;
  if (p.causal) end = min(end, p.q_offset + min(q0 + rows, p.sq));
  return end;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;    // query rows a block
constexpr int kBKV = 64;   // keys a tile

template <int D>
constexpr size_t bf16_smem_bytes() {
  return (size_t)5 * 64 * (D + 8) * sizeof(__nv_bfloat16);   // Q, 2 K, 2 V
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of a (seq, D) slice (row stride ss elements) into
// a shared tile of row stride D + 8; rows >= limit become zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long ss, int row0, int limit,
                                          int tid) {
  constexpr int kPerRow = D / 8;                  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * kPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kPerRow, col = (c % kPerRow) * 8;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* src = ok ? base + (long long)(row0 + r) * ss + col : base;
    cp_async16(dst + r * (D + 8) + col, src, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(Params p) {
  constexpr int S = D + 8;                        // padded row (elements)
  constexpr int kTile = 64 * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTile;                 // [2][kTile]
  __nv_bfloat16* Vs = Ks + 2 * kTile;             // [2][kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;          // mma fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bi = blockIdx.y / p.h, hi = blockIdx.y % p.h;
  const int kh = hi / (p.h / p.kvh);
  const __nv_bfloat16* qb =
      (const __nv_bfloat16*)p.q + bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* kb =
      (const __nv_bfloat16*)p.k + bi * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vb =
      (const __nv_bfloat16*)p.v + bi * p.v_sb + kh * p.v_sh;
  const int n_tiles = (kv_limit(p, q0, kBQ) + kBKV - 1) / kBKV;

  load_tile<D>(Qs, qb, p.q_ss, q0, p.sq, tid);
  load_tile<D>(Ks, kb, p.k_ss, 0, p.skv, tid);
  load_tile<D>(Vs, vb, p.v_ss, 0, p.skv, tid);
  cp_async_commit();

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};           // this thread's part of the row sums
  const int row0 = q0 + warp * 16 + g;
  const int qpos[2] = {p.q_offset + row0, p.q_offset + row0 + 8};
  const __nv_bfloat16* Qw = Qs + warp * 16 * S;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(Ks + (cur ^ 1) * kTile, kb, p.k_ss, (it + 1) * kBKV, p.skv,
                   tid);
      load_tile<D>(Vs + (cur ^ 1) * kTile, vb, p.v_ss, (it + 1) * kBKV, p.skv,
                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* K = Ks + cur * kTile;
    const __nv_bfloat16* V = Vs + cur * kTile;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qw + g * S + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * S);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * S + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = K + (8 * j + g) * S + kk * 16 + 2 * t;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // scale and mask; c0, c1 are row g, c2, c3 row g + 8, keys 2t and 2t + 1
    const int kv0 = it * kBKV;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kv0 + 8 * j + 2 * t + (i & 1);
        float x = s[j][i] * p.scale;
        if (key >= p.skv || (p.causal && key > qpos[i >> 1])) x = kNegInf;
        s[j][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = __expf(s[j][i] - m_r[i >> 1]);
        s[j][i] = e;
        ls[i >> 1] += e;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ls[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V: P's A fragments are S's accumulators (keys 16kk .. 16kk + 15
    // are n-tiles 2kk and 2kk + 1); V's B fragments by ldmatrix.trans, two
    // n-tiles (16 columns of d) a load
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = V + (16 * kk + (mi & 1) * 8 + mr) * S + (mi >> 1) * 8;
#pragma unroll
      for (int m = 0; m < D / 16; ++m) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + 16 * m);
        mma_bf16(oacc[2 * m], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(oacc[2 * m + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();        // buffer `cur` is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = (__nv_bfloat16*)p.o +
                          (((long long)bi * p.sq + row) * p.h + hi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
    if (t == 0)
      p.lse[((long long)bi * p.h + hi) * p.sq + row] = m_r[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 16;   // query rows a block (4 a warp)
constexpr int kF32Kv = 32;     // keys a tile (one a lane)

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)kF32Rows * D + kF32Kv * (D + 1) + kF32Kv * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(Params p) {
  constexpr int E = D / 32;                       // output columns a lane
  constexpr int kRowsPerWarp = kF32Rows / (kThreads / 32);
  extern __shared__ float smf[];
  float* Qs = smf;                                // [16][D]
  float* Ks = Qs + kF32Rows * D;                  // [32][D + 1]
  float* Vs = Ks + kF32Kv * (D + 1);              // [32][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int bi = blockIdx.y / p.h, hi = blockIdx.y % p.h;
  const int kh = hi / (p.h / p.kvh);
  const float* qb = (const float*)p.q + bi * p.q_sb + hi * p.q_sh;
  const float* kb = (const float*)p.k + bi * p.k_sb + kh * p.k_sh;
  const float* vb = (const float*)p.v + bi * p.v_sb + kh * p.v_sh;
  const int kv_end = kv_limit(p, q0, kF32Rows);

  for (int c = tid; c < kF32Rows * D; c += kThreads) {
    const int r = c / D, col = c % D;
    Qs[c] = q0 + r < p.sq ? qb[(long long)(q0 + r) * p.q_ss + col] : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[rr][e] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kF32Kv) {
    __syncthreads();
    for (int c = tid; c < kF32Kv * D; c += kThreads) {
      const int r = c / D, col = c % D;
      const bool ok = kv0 + r < p.skv;
      Ks[r * (D + 1) + col] = ok ? kb[(long long)(kv0 + r) * p.k_ss + col] : 0.f;
      Vs[r * D + col] = ok ? vb[(long long)(kv0 + r) * p.v_ss + col] : 0.f;
    }
    __syncthreads();
    const int key = kv0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = warp * kRowsPerWarp + rr;
      const int qpos = p.q_offset + q0 + row;
      const float* qr = Qs + row * D;
      const float* kr = Ks + lane * (D + 1);
      float sc = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) sc = fmaf(qr[c], kr[c], sc);
      sc *= p.scale;
      if (key >= p.skv || (p.causal && key > qpos)) sc = kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      const float pj = expf(sc - m_new);
      float sum = pj;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[rr][e] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kF32Kv; ++j) {
        const float pjj = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[rr][e] = fmaf(pjj, Vs[j * D + lane + 32 * e], acc[rr][e]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= p.sq) continue;
    float* orow = (float*)p.o + (((long long)bi * p.sq + row) * p.h + hi) * D;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[rr][e] / den;
    if (lane == 0)
      p.lse[((long long)bi * p.h + hi) * p.sq + row] = m[rr] + logf(l[rr]);
  }
}

template <int D>
int launch(const Params& p, bool bf16, cudaStream_t stream) {
  const int rows = bf16 ? kBQ : kF32Rows;
  const dim3 grid((p.sq + rows - 1) / rows, p.b * p.h);
  const size_t smem = bf16 ? bf16_smem_bytes<D>() : f32_smem_bytes<D>();
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16. Strides in elements; the last dimension of q, k and
// v is contiguous, and every row (and the bases) starts on 16 bytes.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int sq, int skv, int h, int kvh, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int q_offset, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
      q_offset < 0 || (long long)b * h > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, (float*)lse, b, sq, skv, h, kvh,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 scale, causal, q_offset};
  const bool bf16 = dtype == 1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch<32>(p, bf16, s);
    case 64: return launch<64>(p, bf16, s);
    case 128: return launch<128>(p, bf16, s);
    case 256: return launch<256>(p, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
