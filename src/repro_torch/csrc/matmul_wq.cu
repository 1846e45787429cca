// Weight-quantized matrix product for Hopper (sm_90a): float activations
// times a packed int8 / int4 power-of-two-scaled weight, with the GRAU
// epilogue optionally fused.
//
// Replaces: the JAX package's kernels/matmul_wq.py::matmul_wq_pallas (body
// _mm_wq_kernel, per-tile dequant _dequant_w_block).
//
// What it computes: out = sum over k-tiles t of x[:, tile t] @ (q_t * 2^e_t)
// with an f32 accumulator, where x is (M, K) f32 or bf16, q the (K_packed, N)
// int8 payload (K_packed = K at 8 bits, K/2 at 4 bits) and e the (K/tile, N)
// int8 exponent plane. At 4 bits packed row i of tile t holds K-element
// t*tile + i in its low nibble and t*tile + i + tile/2 in its high nibble
// (split halves within the tile), unpacked with sign extension in int8:
// (int8)(b << 4) >> 4 and (int8)b >> 4. 2^e is built by bits,
// __int_as_float((e + 127) << 23), so every dequantized weight is exact in
// f32. The output is x's dtype, or, with the epilogue, the 8-bit GRAU bus:
// __float2int_rn(acc * inv_s) (round half even, saturating) through the
// shared grau_datapath (grau_datapath.cuh).
//
// Bound on the H100: memory bytes. At decode (M = 8) and a 32-token prefill
// chunk the weight stream dominates: one int4 llama3.2-3b w_gate is 12.6 MB
// of payload for 0.4 GFLOP at M = 8, ~3.8 us at 3.35 TB/s against ~0.4 us
// of bf16 tensor-core work. Design (simple and right first): one CUDA block
// of 128 threads owns 64 output channels and up to 32 rows of x, and loops
// over the whole K itself (the TPU's sequential K grid axis made a loop,
// the f32 accumulator in registers, 4 x MR values a thread). Each loop step
// takes 64 K-elements: every thread reads its share of the packed rows as
// 16-byte vectors (neighbouring threads on neighbouring columns), with the
// tile's 16-byte exponent vector beside it, and the next step's vectors
// are loaded into registers before the current step computes, so one
// step's loads are in flight during the other's arithmetic. The weights are
// dequantized once into shared memory as f32 and x's slice is staged there
// too; each thread then accumulates a (MR rows x 4 columns) tile with FMAs.
// M above 32 takes a grid over M tiles of 32 rows. No tensor cores, TMA or
// split over K yet: at N = 3072 only 48 blocks stream the weight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grau_datapath.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;                      // output channels per block
constexpr int kColGroups = kBN / 4;          // 4 columns a thread
constexpr int kRowGroups = kThreads / kColGroups;
constexpr int kKC = 64;                      // K-elements per loop step
constexpr int kVecsPerRow = kBN / 16;        // 16-byte vectors per packed row
constexpr int kMaxXPer = 4 * kKC * kRowGroups / kThreads;   // at MR = 4

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutGrau = 2 };

struct Epilogue {
  const int32_t* regs;   // GRAU register file (global), or null
  int num_exponents, qmin, qmax;
  float inv_s;
};

__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}
// byte c of a 16-byte vector held in registers (c is unrolled: no local
// memory round trip)
__device__ __forceinline__ int8_t byte_of(const uint4& v, int c) {
  const uint32_t w = c < 4 ? v.x : c < 8 ? v.y : c < 12 ? v.z : v.w;
  return (int8_t)(w >> (8 * (c & 3)));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// K index of staged row kk of the step whose packed rows start at row r0 of
// tile kt: at 4 bits rows [0, pr) are the low nibbles, [pr, 2 pr) the high.
template <int BITS>
__device__ __forceinline__ int k_index(int kt, int tile, int r0, int pr,
                                       int kk) {
  if (BITS == 8) return kt * tile + r0 + kk;
  return kk < pr ? kt * tile + r0 + kk : kt * tile + tile / 2 + r0 + kk - pr;
}

template <typename T, int BITS, int MR>
__global__ void __launch_bounds__(kThreads)
matmul_wq_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const int8_t* __restrict__ e, void* __restrict__ out, int M,
                 int N, int K, int tile, int pr, int out_kind, Epilogue epi) {
  constexpr int MT = MR * kRowGroups;              // rows of x per block
  constexpr int kVecs = (BITS == 4 ? kKC / 2 : kKC) * kVecsPerRow / kThreads;
  constexpr int kXPer = MT * kKC / kThreads;
  static_assert(kXPer <= kMaxXPer, "x staging");
  __shared__ __align__(16) float ws[kKC][kBN];
  __shared__ float xs[MT][kKC + 1];
  __shared__ int32_t regs[GRAU_REG_WORDS];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * MT;
  const int tp = BITS == 4 ? tile / 2 : tile;      // packed rows per tile
  const int steps_per_tile = tp / pr;
  const int steps = (K / tile) * steps_per_tile;
  const int kc = BITS == 4 ? 2 * pr : pr;          // K-elements this step
  const int nvec = pr * kVecsPerRow;               // vectors this step
  const int vcol = tid % kVecsPerRow;              // fixed for every vector
  const int col = n0 + vcol * 16;
  const bool col_ok = col < N;                     // N % 16 == 0
  const int cg = tid % kColGroups, rg = tid / kColGroups;

  if (out_kind == kOutGrau && tid < GRAU_REG_WORDS) regs[tid] = epi.regs[tid];

  uint4 qv[kVecs], ev;
  float xr[kXPer];
  auto load = [&](int s) {
    const int kt = s / steps_per_tile, r0 = (s % steps_per_tile) * pr;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int vi = tid + j * kThreads;
      qv[j] = make_uint4(0, 0, 0, 0);
      if (vi < nvec && col_ok)
        qv[j] = *reinterpret_cast<const uint4*>(
            q + (size_t)(kt * tp + r0 + vi / kVecsPerRow) * N + col);
    }
    ev = make_uint4(0, 0, 0, 0);
    if (col_ok)
      ev = *reinterpret_cast<const uint4*>(e + (size_t)kt * N + col);
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int idx = tid + j * kThreads, m = idx / kKC, kk = idx % kKC;
      xr[j] = 0.f;
      if (m0 + m < M && kk < kc)
        xr[j] = to_f32(x[(size_t)(m0 + m) * K +
                         k_index<BITS>(kt, tile, r0, pr, kk)]);
    }
  };

  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  load(0);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();   // the previous step's reads of ws / xs are done
    float scale[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) scale[c] = exp2i(byte_of(ev, c));
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int vi = tid + j * kThreads;
      if (vi >= nvec) continue;
      const int r = vi / kVecsPerRow;
      float* lo_row = &ws[r][vcol * 16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int8_t b = byte_of(qv[j], c);
        if (BITS == 8) {
          lo_row[c] = (float)b * scale[c];
        } else {
          const int8_t lo = (int8_t)((uint8_t)b << 4) >> 4;
          const int8_t hi = b >> 4;
          lo_row[c] = (float)lo * scale[c];
          ws[r + pr][vcol * 16 + c] = (float)hi * scale[c];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int idx = tid + j * kThreads;
      xs[idx / kKC][idx % kKC] = xr[j];
    }
    __syncthreads();
    if (s + 1 < steps) load(s + 1);   // in flight during this step's math
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][cg * 4]);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float xv = xs[rg * MR + i][kk];
        acc[i][0] = fmaf(xv, w.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = m0 + rg * MR + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + cg * 4 + c;
      if (n >= N) continue;
      const size_t off = (size_t)m * N + n;
      if (out_kind == kOutF32) {
        reinterpret_cast<float*>(out)[off] = acc[i][c];
      } else if (out_kind == kOutBF16) {
        reinterpret_cast<__nv_bfloat16*>(out)[off] =
            __float2bfloat16_rn(acc[i][c]);
      } else {
        const int32_t xq = __float2int_rn(acc[i][c] * epi.inv_s);
        reinterpret_cast<uint8_t*>(out)[off] = (uint8_t)grau_datapath(
            xq, regs, epi.num_exponents, epi.qmin, epi.qmax);
      }
    }
  }
}

template <typename T, int BITS, int MR>
int launch(const void* x, const void* q, const void* e, void* out, int M,
           int N, int K, int tile, int pr, int out_kind, Epilogue epi,
           cudaStream_t stream) {
  constexpr int MT = MR * kRowGroups;
  const dim3 grid((N + kBN - 1) / kBN, (M + MT - 1) / MT);
  matmul_wq_kernel<T, BITS, MR><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const int8_t*)q, (const int8_t*)e, out, M, N, K, tile, pr,
      out_kind, epi);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int dispatch_m(const void* x, const void* q, const void* e, void* out, int M,
               int N, int K, int tile, int pr, int out_kind, Epilogue epi,
               cudaStream_t st) {
  if (M <= 8)
    return launch<T, BITS, 1>(x, q, e, out, M, N, K, tile, pr, out_kind, epi,
                              st);
  if (M <= 16)
    return launch<T, BITS, 2>(x, q, e, out, M, N, K, tile, pr, out_kind, epi,
                              st);
  return launch<T, BITS, 4>(x, q, e, out, M, N, K, tile, pr, out_kind, epi,
                            st);
}

template <typename T>
int dispatch_bits(int bits, const void* x, const void* q, const void* e,
                  void* out, int M, int N, int K, int tile, int pr,
                  int out_kind, Epilogue epi, cudaStream_t st) {
  if (bits == 8)
    return dispatch_m<T, 8>(x, q, e, out, M, N, K, tile, pr, out_kind, epi,
                            st);
  return dispatch_m<T, 4>(x, q, e, out, M, N, K, tile, pr, out_kind, epi, st);
}

}  // namespace

// x: (M, K) f32 (dtype 0) or bf16 (dtype 1); q: (K or K/2, N) int8; e:
// (K/tile, N) int8; out_kind: 0 = f32, 1 = bf16, 2 = GRAU byte (regs:
// the register file). N must be a multiple of 16 and q, e 16-byte aligned.
extern "C" int matmul_wq_launch(const void* x, const void* q, const void* e,
                                void* out, int M, int N, int K, int tile,
                                int bits, int dtype, int out_kind,
                                const void* regs, int num_exponents, int qmin,
                                int qmax, float inv_s, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || tile <= 0 || K % tile != 0 || N % 16 != 0 ||
      (bits != 8 && bits != 4) || (bits == 4 && tile % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (out_kind == kOutGrau && regs == nullptr)
    return (int)cudaErrorInvalidValue;
  // packed rows per loop step: the largest power of two <= kKC / (elements
  // per byte) that divides the tile's packed rows, so a step never
  // straddles two tiles (two exponent rows)
  const int tp = bits == 4 ? tile / 2 : tile;
  int pr = bits == 4 ? kKC / 2 : kKC;
  while (tp % pr != 0) pr >>= 1;
  const Epilogue epi{(const int32_t*)regs, num_exponents, qmin, qmax, inv_s};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_bits<float>(bits, x, q, e, out, M, N, K, tile, pr,
                                out_kind, epi, st);
  if (dtype == 1)
    return dispatch_bits<__nv_bfloat16>(bits, x, q, e, out, M, N, K, tile, pr,
                                        out_kind, epi, st);
  return (int)cudaErrorInvalidValue;
}
