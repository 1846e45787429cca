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
// (split halves within the tile; the layout is read as it is, never
// repacked). The output is f32 or bf16, or, with the epilogue, the 8-bit
// GRAU bus: __float2int_rn(acc * inv_s) (round half even, saturating)
// through the shared grau_datapath (grau_datapath.cuh).
//
// Bound on the H100: memory bytes. At decode (M = 8) and a 32-token prefill
// chunk the weight stream dominates: one int4 llama3.2-3b w_gate is 12.6 MB
// of payload for 0.4 GFLOP at M = 8, ~3.8 us at 3.35 TB/s against ~0.4 us
// of bf16 tensor-core work. Holding that rate takes a few MB in flight on
// the chip, every SM busy, and a dequant cheap enough to keep up.
//
// Design:
//   * Grid: (column tiles of 128 channels) x (K parts) x (row tiles of up
//     to 32). A part is a run of whole pack tiles, so each part starts on a
//     new exponent row; the wrapper plans the part count on the host so
//     that the grid holds at least two blocks per SM (w_down int4 at M 8:
//     24 column tiles x 16 parts). With one part the block writes the
//     output itself; with more, each part writes its f32 partial sums to a
//     workspace [parts, M, N] and a second launch from the same C entry
//     sums them in part order (no atomics: the sum is the same on every
//     run, so the fused epilogue equals the epilogue on the f32 output).
//   * Loads: each block streams its packed slab through a 4-stage cp.async
//     ring in shared memory as raw bytes: a stage is 64 packed rows x 128
//     channels (8 KB) with its exponent row and x's matching columns, so
//     three stages (24 KB a block, several blocks an SM) are in flight
//     while one is computed; one __syncthreads a stage.
//   * Math on the bf16 tensor cores: mma.sync m16n8k16 with the weight as
//     A (16 output channels x 16 K) and x^T as B (K x 8 rows), f32
//     accumulators in registers. Weights are dequantized in registers
//     straight to bf16, exactly: q * 2^e needs 8 significand bits and an
//     exponent >= -126, which bf16 has. int4: one prmt gathers two packed
//     rows' bytes, (w & 0x000F000F) ^ 0x43084308 makes two bf16 values
//     128 + (n ^ 8), and one bf16x2 fma by (2^e, -136 * 2^e) leaves q *
//     2^e: 1.5 instructions a weight. int8: a prmt into 0x4B0000xx and an
//     f32 fma, then a bf16x2 pack. The mma's K order is free as long as A
//     and B agree, so a register pairs the two rows a thread loaded (and at
//     4 bits the low nibbles of one pair with the high nibbles of the same
//     bytes); x is staged in the matching order, low half and high half.
//   * f32 activations take the same grid and ring: x is split in registers
//     into bf16 hi + mid + lo (x - hi - mid - lo is below 2^-26 |x|) and
//     each weight fragment goes through three mmas.
//   * Ragged shapes: any pack tile (even at 4 bits). Payload rows and x
//     columns past a tile's tp packed rows are staged as zeros, so a tile
//     narrower than a stage, or than an mma step, adds exact zeros. Where
//     x's columns of a tile half are not whole 16-byte vectors (tp not a
//     multiple of 16 / sizeof(x) elements: a 4-bit tile of 24), x is staged
//     element by element with plain loads instead of cp.async (no served
//     shape does this). N must be a multiple of 16, so that weight rows are
//     whole 16-byte vectors: the wrapper pads the payload and exponents of a
//     ragged N with zero bytes (exact zeros, as the reference's padding) and
//     slices the output.
// Needs N % 16 == 0 and 16-byte aligned q, e and x (the wrapper checks).
// Every product is exact; the sums are the reference's in another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kThreads = 128;                // 4 warps, 32 channels each
constexpr int kBN = 128;                     // output channels a block
constexpr int kPR = 64;                      // packed rows a stage
constexpr int kStages = 4;
constexpr int kWStride = kBN + 16;           // staged weight row (bytes)
constexpr int kWBytes = kPR * kWStride;
constexpr int kMaxParts = 1 << 15;

// Shared-memory layout of one ring stage for activations T, BITS and NT
// n8 groups (8 * NT rows of x).
template <typename T, int BITS, int NT>
struct Stage {
  static constexpr int XK = BITS == 4 ? 2 * kPR : kPR;   // K values a stage
  static constexpr int XS = XK + 8;      // x row stride (elements): the row
                                         // starts 4 (bf16) / 8 (f32) banks on
  static constexpr int kXBytes = 8 * NT * XS * (int)sizeof(T);
  static constexpr int kBytes = kWBytes + kBN + kXBytes;
  static constexpr int kSmem = kStages * kBytes;
};

struct Problem {
  const void* x;
  const int8_t* q;
  const int8_t* e;
  void* out;        // the output (one part) or the f32 workspace
  int M, N, K, tile, tpp;   // tpp: pack tiles a part
  int x_vec;        // x's tile halves are whole 16-byte vectors
  int out_kind;     // kOut* of `out`; the workspace is written as f32
  Epilogue epi;
};

template <typename T, int BITS, int NT>
__global__ void __launch_bounds__(kThreads)
matmul_wq_kernel(Problem p) {
  using L = Stage<T, BITS, NT>;
  constexpr int MT = 8 * NT;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kXChunk = 16 / (int)sizeof(T);          // x values a 16 B chunk
  constexpr int kXChunks = MT * L::XK / kXChunk;
  constexpr int kKSteps = BITS == 4 ? kPR / 8 : kPR / 16;   // mma K steps
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, part = blockIdx.y, m0 = blockIdx.z * MT;
  const int tp = BITS == 4 ? p.tile / 2 : p.tile;       // packed rows a tile
  const int kt_total = p.K / p.tile;
  const int kt0 = part * p.tpp;
  const int kt1 = min(kt0 + p.tpp, kt_total);
  const int spt = (tp + kPR - 1) / kPR;                 // stages a tile
  const int n_stages = (kt1 - kt0) * spt;
  const T* x = (const T*)p.x;

  auto issue = [&](int s) {
    if (s < n_stages) {
      unsigned char* st = smem + (s % kStages) * L::kBytes;
      const int kt = kt0 + s / spt, r0 = (s % spt) * kPR;
      // payload: 64 rows x 128 channels, 8 chunks a row
#pragma unroll
      for (int j = 0; j < kPR * (kBN / 16) / kThreads; ++j) {
        const int c = tid + j * kThreads, r = c / (kBN / 16),
                  col = (c % (kBN / 16)) * 16;
        const bool ok = r0 + r < tp && n0 + col < p.N;
        const int8_t* src =
            ok ? p.q + (size_t)(kt * tp + r0 + r) * p.N + n0 + col : p.q;
        cp_async16(st + r * kWStride + col, src, ok);
      }
      if (tid < kBN / 16) {                            // the exponent row
        const bool ok = n0 + tid * 16 < p.N;
        cp_async16(st + kWBytes + tid * 16,
                   ok ? p.e + (size_t)kt * p.N + n0 + tid * 16 : p.e, ok);
      }
      // x: stage column j holds K-element kt*tile + r0 + j (4 bits: the
      // low nibbles' rows for j < 64, the high nibbles' for j >= 64)
      T* xs = reinterpret_cast<T*>(st + kWBytes + kBN);
      if (p.x_vec) {
        for (int c = tid; c < kXChunks; c += kThreads) {
          const int m = c / (L::XK / kXChunk);
          const int j = (c % (L::XK / kXChunk)) * kXChunk;
          const int half = BITS == 4 ? j / kPR : 0;
          const int i = BITS == 4 ? j % kPR : j;
          const bool ok = m0 + m < p.M && r0 + i < tp;
          const T* src = ok ? x + (size_t)(m0 + m) * p.K + kt * p.tile +
                                  half * tp + r0 + i
                            : x;
          cp_async16(xs + m * L::XS + j, src, ok);
        }
      } else {          // element by element (visible after __syncthreads)
        for (int c = tid; c < MT * L::XK; c += kThreads) {
          const int m = c / L::XK, j = c % L::XK;
          const int half = BITS == 4 ? j / kPR : 0;
          const int i = BITS == 4 ? j % kPR : j;
          const bool ok = m0 + m < p.M && r0 + i < tp;
          xs[m * L::XS + j] = ok ? x[(size_t)(m0 + m) * p.K + kt * p.tile +
                                     half * tp + r0 + i]
                                 : T(0.f);
        }
      }
    }
    cp_async_commit();   // always: keeps the group count per stage fixed
  };

  float acc[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int ng = 0; ng < NT; ++ng)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][ng][i] = 0.f;

  // this thread's 4 channels: bytes [wcol, wcol + 4) of every staged row;
  // channel wcol + 2j + h is row g + 8h of the warp's j-th mma tile
  const int wcol = 32 * warp + 4 * g;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage s landed; stage s - 1 is consumed everywhere
    issue(s + kStages - 1);
    const unsigned char* st = smem + (s % kStages) * L::kBytes;
    const T* xs = reinterpret_cast<const T*>(st + kWBytes + kBN);
    const uint32_t ew = *reinterpret_cast<const uint32_t*>(st + kWBytes + wcol);
    uint32_t s2[4], c2[4];
    float sf[4], cf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sc = exp2i((int8_t)(ew >> (8 * i)));
      if (BITS == 4) {
        int4_scale(sc, s2[i], c2[i]);
      } else {
        sf[i] = sc;
        cf[i] = int8_bias(sc);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t a[2][4];
      int klo, khi;       // x columns of this step's B fragment pairs
      if (BITS == 4) {
        const int r = 8 * ks + 2 * t;          // rows r, r + 1: K pairs
        const uint32_t A = *reinterpret_cast<const uint32_t*>(
            st + r * kWStride + wcol);
        const uint32_t B = *reinterpret_cast<const uint32_t*>(
            st + (r + 1) * kWStride + wcol);
        const uint32_t lo = __byte_perm(A, B, 0x5410);   // A0 A1 B0 B1
        const uint32_t hi = __byte_perm(A, B, 0x7632);   // A2 A3 B2 B3
        a[0][0] = int4_pair(lo, 0, s2[0], c2[0]);
        a[0][2] = int4_pair(lo, 4, s2[0], c2[0]);
        a[0][1] = int4_pair(lo, 8, s2[1], c2[1]);
        a[0][3] = int4_pair(lo, 12, s2[1], c2[1]);
        a[1][0] = int4_pair(hi, 0, s2[2], c2[2]);
        a[1][2] = int4_pair(hi, 4, s2[2], c2[2]);
        a[1][1] = int4_pair(hi, 8, s2[3], c2[3]);
        a[1][3] = int4_pair(hi, 12, s2[3], c2[3]);
        klo = r;
        khi = kPR + r;
      } else {
        const int r = 16 * ks + 2 * t;         // rows r, r+1 and r+8, r+9
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(
                     st + (r + (i & 1) + 8 * (i >> 1)) * kWStride + wcol) ^
                 0x80808080u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {          // channel wcol + c
          const uint32_t vlo = pack_bf16(int8_val(w[0], c, sf[c], cf[c]),
                                         int8_val(w[1], c, sf[c], cf[c]));
          const uint32_t vhi = pack_bf16(int8_val(w[2], c, sf[c], cf[c]),
                                         int8_val(w[3], c, sf[c], cf[c]));
          a[c >> 1][c & 1] = vlo;
          a[c >> 1][2 + (c & 1)] = vhi;
        }
        klo = r;
        khi = r + 8;
      }
#pragma unroll
      for (int ng = 0; ng < NT; ++ng) {
        const T* xr = xs + (8 * ng + g) * L::XS;
        if (!kF32) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + klo);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + khi);
          mma_bf16(acc[0][ng], a[0], b0, b1);
          mma_bf16(acc[1][ng], a[1], b0, b1);
        } else {
          // x = hi + mid + lo in bf16, each through the tensor cores
          const float2 f0 = *reinterpret_cast<const float2*>(xr + klo);
          const float2 f1 = *reinterpret_cast<const float2*>(xr + khi);
          float r0x = f0.x, r0y = f0.y, r1x = f1.x, r1y = f1.y;
#pragma unroll
          for (int part3 = 0; part3 < 3; ++part3) {
            const uint32_t b0 = pack_bf16(r0x, r0y);
            const uint32_t b1 = pack_bf16(r1x, r1y);
            r0x -= bf16_lo(b0);
            r0y -= bf16_hi(b0);
            r1x -= bf16_lo(b1);
            r1y -= bf16_hi(b1);
            mma_bf16(acc[0][ng], a[0], b0, b1);
            mma_bf16(acc[1][ng], a[1], b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // outputs: acc[j][ng] = channels (wcol + 2j, + 1) x rows (2t, 2t + 1) of
  // group ng; per row, the thread holds 4 consecutive channels
  const int n = n0 + wcol;
  if (n >= p.N) return;                        // N % 16 == 0: all 4 or none
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int ng = 0; ng < NT; ++ng)
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      const int m = m0 + 8 * ng + 2 * t + mm;
      if (m >= p.M) continue;
      const float v[4] = {acc[0][ng][mm], acc[0][ng][2 + mm], acc[1][ng][mm],
                          acc[1][ng][2 + mm]};
      if (direct) {
        store4(p.out, (size_t)m * p.N + n, v, p.out_kind, p.epi.regs, p.epi);
      } else {
        store4(p.out, ((size_t)part * p.M + m) * p.N + n, v, kOutF32, nullptr,
               p.epi);
      }
    }
}

// Sums the parts' f32 partials in part order, then writes the output.
__global__ void __launch_bounds__(256)
reduce_parts_kernel(const float* __restrict__ ws, void* __restrict__ out,
                    int parts, int M, int N, int out_kind, Epilogue epi) {
  __shared__ int32_t regs[GRAU_REG_WORDS];
  if (out_kind == kOutGrau && threadIdx.x < GRAU_REG_WORDS)
    regs[threadIdx.x] = epi.regs[threadIdx.x];
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)M * N / 4;
  if (idx >= n4) return;
  float4 s = reinterpret_cast<const float4*>(ws)[idx];
  for (int pi = 1; pi < parts; ++pi) {
    const float4 v = reinterpret_cast<const float4*>(ws)[pi * n4 + idx];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float v[4] = {s.x, s.y, s.z, s.w};
  store4(out, 4 * idx, v, out_kind, regs, epi);
}

template <typename T, int BITS, int NT>
int launch(const Problem& p, int parts, cudaStream_t st) {
  using L = Stage<T, BITS, NT>;
  auto kern = matmul_wq_kernel<T, BITS, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + kBN - 1) / kBN, parts, (p.M + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kThreads, L::kSmem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int dispatch_m(const Problem& p, int parts, cudaStream_t st) {
  if (p.M <= 8) return launch<T, BITS, 1>(p, parts, st);
  if (p.M <= 16) return launch<T, BITS, 2>(p, parts, st);
  return launch<T, BITS, 4>(p, parts, st);
}

}  // namespace

// x: (M, K) f32 (dtype 0) or bf16 (dtype 1); q: (K or K/2, N) int8; e:
// (K/tile, N) int8; out_kind: 0 = f32, 1 = bf16, 2 = GRAU byte (regs: the
// register file). `parts` K parts of `tpp` pack tiles each (the last may be
// shorter); with parts > 1, `ws` is an f32 workspace of parts * M * N.
// Needs N % 16 == 0 (the wrapper pads), an even tile at 4 bits, and x, q,
// e on 16-byte boundaries.
extern "C" int matmul_wq_launch(const void* x, const void* q, const void* e,
                                void* out, void* ws, int M, int N, int K,
                                int tile, int bits, int dtype, int out_kind,
                                int parts, int tpp, const void* regs,
                                int num_exponents, int qmin, int qmax,
                                float inv_s, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || tile <= 0 || K % tile != 0 || (bits == 4 && tile % 2) ||
      N % 16 != 0 || (bits != 8 && bits != 4) || tpp < 1 || parts < 1 ||
      parts > kMaxParts || (parts - 1) * tpp >= K / tile ||
      parts * tpp < K / tile || (dtype != 0 && dtype != 1) ||
      (M + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  if (out_kind == kOutGrau && regs == nullptr)
    return (int)cudaErrorInvalidValue;
  if (parts > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Epilogue epi{(const int32_t*)regs, num_exponents, qmin, qmax, inv_s};
  // x's tile halves (tp columns, from K-element kt * tile + half * tp) are
  // whole 16-byte vectors when tp is a multiple of 16 bytes of x
  const int tp = bits == 4 ? tile / 2 : tile;
  const int x_vec = tp % (dtype == 0 ? 4 : 8) == 0;
  const Problem p{x, (const int8_t*)q, (const int8_t*)e,
                  parts > 1 ? ws : out, M, N, K, tile, tpp, x_vec, out_kind,
                  epi};
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (dtype == 0)
    err = bits == 8 ? dispatch_m<float, 8>(p, parts, st)
                    : dispatch_m<float, 4>(p, parts, st);
  else
    err = bits == 8 ? dispatch_m<__nv_bfloat16, 8>(p, parts, st)
                    : dispatch_m<__nv_bfloat16, 4>(p, parts, st);
  if (err != 0 || parts == 1) return err;
  const size_t n4 = (size_t)M * N / 4;
  reduce_parts_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      (const float*)ws, out, parts, M, N, out_kind, epi);
  return (int)cudaGetLastError();
}
