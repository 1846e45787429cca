// Fused int8 matrix product + GRAU epilogue for Hopper (sm_90a): the paper's
// "End-to-End MAC to Quant" — an int8 MAC array whose outputs go straight
// through the GRAU unit, so no int32 activation ever reaches device memory.
//
// Replaces: the JAX package's kernels/matmul_grau.py::matmul_grau_pallas
// (body _mm_grau_kernel; the epilogue is grau_datapath).
//
// What it computes: out[m, n] = grau(sum_k x[m, k] * w[k, n]) for x (M, K)
// int8 row-major, w (K, N) int8 row-major (N contiguous, the reference's
// layout); the sum is exact in int32 and wraps modulo 2^32 as the
// reference's int32 dot does (mma.sync without .satfinite wraps). The bus
// byte is int8 or uint8 by the mode register (the clamped value fits
// either, so the byte is the same; the wrapper picks the tensor type).
//
// Bound on the H100: operations at the MLP widths. M 2048, K 3072, N 8192
// is 103 G int8 operations (52 us at 1,979 TOP/s) against 48 MB of bytes
// (14 us at 3.35 TB/s); at M = 32 the weight stream bounds it instead.
//
// Design (right and simple first; wgmma, TMA and a persistent grid are for
// the PR that makes it fast):
//   * One block of 256 threads owns a 128 x 128 output tile and loops over
//     K in steps of 64 (the TPU's sequential K grid axis with its VMEM
//     accumulator becomes this loop, the int32 sums in registers: 8 warps of
//     64 x 32, 64 accumulators a thread). The GRAU epilogue runs once, after
//     the loop, with the 32-word register file staged in shared memory.
//   * Products on the int8 tensor cores: mma.sync m16n8k32 s8.s8.s32, A row-
//     major and B "col", i.e. both operands K-contiguous. x already is; w is
//     N-contiguous and ldmatrix.trans moves 16-bit elements only, so each
//     thread reads a 4 (k) x 4 (n) byte block of w and transposes it in
//     registers with four __byte_perm pairs while staging it into shared
//     memory as 16 words per column n (4 k-values a word), at word
//     (kw ^ swz(n)): the XOR swizzle makes the fragment reads conflict-free
//     and the staging stores at most two-way. (wgmma with s8 also takes
//     both operands K-major only, so the fast kernel keeps this transpose or
//     asks for w stored as (N, K).) x rows are staged padded to 80 bytes,
//     which makes its fragment reads conflict-free too.
//   * Double buffering through registers: the next K step's global loads
//     are issued before the current step's products, and land in the other
//     shared buffer after them; one barrier a step.
//   * Ragged edges are masked, never padded by a copy: rows past M and
//     K past its end load as zeros, columns past N are not stored. When K is
//     a multiple of 16, N of 4 and the bases aligned, x moves in 16-byte and
//     w in 4-byte loads; otherwise a byte-wise loader takes any shape.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grau_datapath.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;              // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMT = kWarpM / 16;           // m16 tiles a warp
constexpr int kNT = kWarpN / 8;            // n8 tiles a warp
constexpr int kAStride = kBK + 16;         // bytes per staged x row
constexpr int kBWords = kBK / 4;           // words per staged w column
constexpr int kChunks = 2;                 // 16-byte x chunks a thread a step
constexpr int kBlocks = 2;                 // 4x4 w blocks a thread a step

// where word kw (4 k-values) of staged column n lives within its 16 words
__device__ __forceinline__ int swz(int n) {
  return ((n >> 3) & 3) | ((((n >> 1) ^ (n >> 5)) & 3) << 2);
}

struct Staged {
  uint4 a[kChunks];          // x: row c / 4, bytes 16 (c % 4) .. + 15
  uint32_t b[kBlocks][4];    // w: 4 rows (k) of 4 bytes (n) each
};

// The K step starting at k0: chunk c = tid + i * kThreads of x is row c / 4,
// k-bytes 16 (c % 4) ..; block id = tid + i * kThreads of w is n-quad
// id % 32 (the lane: a warp reads 128 contiguous bytes of a w row) and
// k-quad id / 32.
template <bool kVec>
__device__ __forceinline__ void load_step(Staged& st, const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w, int M,
                                          int N, int K, int bm, int bn, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kThreads;
    const int row = bm + (c >> 2);
    const int k = k0 + (c & 3) * 16;
    if (kVec) {
      st.a[i] = (row < M && k < K)
                    ? __ldg(reinterpret_cast<const uint4*>(x + (int64_t)row * K + k))
                    : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kk = k + q * 4 + b;
          if (row < M && kk < K)
            word |= (uint32_t)(uint8_t)x[(int64_t)row * K + kk] << (8 * b);
        }
        v[q] = word;
      }
      st.a[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < kBlocks; ++i) {
    const int id = tid + i * kThreads;
    const int n = bn + (id & 31) * 4;
    const int kq = k0 + (id >> 5) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kq + r;
      if (kVec) {
        st.b[i][r] = (k < K && n < N)
                         ? __ldg(reinterpret_cast<const unsigned int*>(
                               w + (int64_t)k * N + n))
                         : 0u;
      } else {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (k < K && n + b < N)
            word |= (uint32_t)(uint8_t)w[(int64_t)k * N + n + b] << (8 * b);
        }
        st.b[i][r] = word;
      }
    }
  }
}

__device__ __forceinline__ void store_step(const Staged& st, uint8_t* As,
                                           uint32_t* Bs, int tid) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(As + (c >> 2) * kAStride + (c & 3) * 16) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < kBlocks; ++i) {
    const int id = tid + i * kThreads;
    const int nq = id & 31, kw = id >> 5;
    const uint32_t* r = st.b[i];
    // 4x4 byte transpose: col[j] holds column j's bytes of rows 0..3
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410),
                             __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410),
                             __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nq * 4 + j;
      Bs[n * kBWords + (kw ^ swz(n))] = col[j];
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
matmul_grau_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   uint8_t* __restrict__ out, int M, int N, int K,
                   const int32_t* __restrict__ regs_g, int num_exponents,
                   int qmin, int qmax) {
  __shared__ __align__(16) uint8_t As[2][kBM * kAStride];
  __shared__ __align__(16) uint32_t Bs[2][kBN * kBWords];
  __shared__ int32_t regs[GRAU_REG_WORDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;        // mma fragment coordinates
  const int wm = (warp >> 2) * kWarpM, wn = (warp & 3) * kWarpN;
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  if (tid < GRAU_REG_WORDS) regs[tid] = regs_g[tid];

  int32_t acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  const int steps = (K + kBK - 1) / kBK;
  Staged st;
  if (steps > 0) {
    load_step<kVec>(st, x, w, M, N, K, bm, bn, 0, tid);
    store_step(st, As[0], Bs[0], tid);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load_step<kVec>(st, x, w, M, N, K, bm, bn, (s + 1) * kBK, tid);
    const uint8_t* A = As[cur];
    const uint32_t* B = Bs[cur];
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const uint8_t* p = A + (wm + mi * 16 + g) * kAStride + ks * 32 + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int n = wn + ni * 8 + g;
        const int kw = ks * 8 + t, sw = swz(n);
        b[ni][0] = B[n * kBWords + (kw ^ sw)];
        b[ni][1] = B[n * kBWords + ((kw + 4) ^ sw)];
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    if (s + 1 < steps) store_step(st, As[cur ^ 1], Bs[cur ^ 1], tid);
    __syncthreads();
  }

  // epilogue: the GRAU datapath on each accumulator, once; c0/c1 are row g,
  // c2/c3 row g + 8, columns 2t and 2t + 1 of each n8 tile
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = bm + wm + mi * 16 + g + (i >> 1) * 8;
        const int col = bn + wn + ni * 8 + t * 2 + (i & 1);
        if (row < M && col < N)
          out[(int64_t)row * N + col] = (uint8_t)grau_datapath(
              acc[mi][ni][i], regs, num_exponents, qmin, qmax);
      }
}

}  // namespace

extern "C" int matmul_grau_launch(const void* x, const void* w, void* out,
                                  int M, int N, int K, const void* regs,
                                  int num_exponents, int qmin, int qmax,
                                  void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && N % 4 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)w % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    matmul_grau_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int8_t*)x, (const int8_t*)w, (uint8_t*)out, M, N, K,
        (const int32_t*)regs, num_exponents, qmin, qmax);
  else
    matmul_grau_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int8_t*)x, (const int8_t*)w, (uint8_t*)out, M, N, K,
        (const int32_t*)regs, num_exponents, qmin, qmax);
  return (int)cudaGetLastError();
}
