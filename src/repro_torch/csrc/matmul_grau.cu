// Fused int8 matrix product + GRAU epilogue for Hopper (sm_90a): the paper's
// "End-to-End MAC to Quant" — an int8 MAC array whose outputs go straight
// through the GRAU unit, so no int32 activation reaches device memory when
// K is not split.
//
// Replaces: the JAX package's kernels/matmul_grau.py::matmul_grau_pallas
// (body _mm_grau_kernel; the epilogue is grau_datapath).
//
// What it computes: out[m, n] = grau(sum_k x[m, k] * w[k, n]) for x (M, K)
// int8 row-major, w (K, N) int8 row-major (N contiguous, the reference's
// layout); the sum is exact in int32 and wraps modulo 2^32 as the
// reference's int32 dot does (wgmma without .satfinite wraps). The bus byte
// is int8 or uint8 by the mode register (the clamped value fits either, so
// the byte is the same; the wrapper picks the tensor type).
//
// Bound on the H100: operations at 2048 rows (M 2048, K 3072, N 8192 is
// 103 G int8 operations, 52 us at 1,979 TOP/s, against 48 MB, 14 us at
// 3.35 TB/s); the weight's bytes at 32 rows (25 MB, 7.6 us).
//
// Design:
//   * Operands swapped: each block computes a tile of out^T = w^T x^T, so
//     the weight's N fills wgmma's fixed 64-row side and x's rows become
//     wgmma's N (32 or 128 by the plan: a 32-row product multiplies no
//     zero rows). x (M, K) row-major is K-major, wgmma's shared B operand:
//     TMA loads it with the 128-byte swizzle. s8 wgmma takes no N-major
//     operand from shared memory, so w (N contiguous) goes in as the
//     register A operand: TMA lands w tiles as rows of 128 bytes (128 n)
//     per k in the same swizzle, and each consumer thread reads 4 x 4 byte
//     blocks (4 k rows x 4 n columns, one 32-bit load a row) and transposes
//     them with __byte_perm into A fragments (4 consecutive k a register);
//     the lanes of the upper two k-quads read their rows in rotated order,
//     so the 8 loads of a k step are conflict-free. A thread's 4 columns go
//     to rows g, g + 8 of two 64-row tiles, so after the products each
//     thread holds, for each of its x rows, 4 consecutive outputs of one row
//     of out: the transpose back costs nothing.
//   * Block: a producer warpgroup (setmaxnreg down to 40; one thread
//     issues the TMA loads) and two consumer warpgroups (up to 232), each
//     owning 128 w columns (two m64 wgmma tiles sharing one B): 256
//     columns x 32 or 128 rows a block. A ring of 6 or 4 stages of 128 k
//     (36 or 48 KB a stage) with full/empty mbarriers; within a stage the
//     consumers build the next k step's A fragments while the previous
//     step's products run (two A register sets, wgmma.wait_group 1), and
//     they release a stage once its products have retired.
//   * Epilogue: the int32 sums go through shared memory (the idle ring, 4
//     consecutive columns a 16-byte store), and a rolled loop runs the GRAU
//     datapath on 4 sums a thread a pass (grau_eval4: only the fired
//     stages) and writes 4 bytes, a warp 128 contiguous bytes of a row of
//     out.
//   * Split K, planned on the host (kernels/matmul_grau.plan, a function of
//     the shapes and the SM count only, so a launch is graph-capturable):
//     when the output tiles are fewer than the SMs, each of `parts` blocks
//     of a tile sums a run of `spp` k steps and stores its int32 partial
//     sums to a workspace [parts, M, N]; a second launch sums the parts
//     (modulo 2^32: any order gives the same integers) and runs the GRAU
//     datapath once per output. With one part the datapath runs on the
//     accumulators.
//   * Edges: TMA zero-fills rows past M, columns past N and k past K, and
//     stores are masked. TMA needs K and N multiples of 16 and both bases
//     on 16 bytes; any other shape (K 200, 260, N 96 + 1, a view that
//     starts mid-row) runs the same kernel with the producer warpgroup
//     writing the tiles byte by byte into the same swizzled layout.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grau_datapath.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBK = 128;                // k a stage: one swizzled x row
constexpr int kBN = 256;                // w columns a block
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kWBox = 128;              // w columns a TMA box
constexpr int kWPanel = kBK * kWBox;    // a w box: 16 KB
constexpr int kWStage = 2 * kWPanel;    // 256 columns
constexpr int kStRow = 128 * 4 + 16;    // a staged row of int32 sums
// registers a thread (setmaxnreg) of the producer warpgroup and of the
// consumers: 128 x 40 + 256 x 232 = 384 x 168, the launch bound's budget
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BM>
struct Cfg {
  static constexpr int kX = BM * kBK;                       // x tile bytes
  static constexpr int kStage = kX + kWStage;
  static constexpr int kStages = BM == 128 ? 4 : 6;
  static constexpr int kBar = kStages * kStage;             // barriers
  static constexpr int kSmem = kBar + 16 * kStages + 1024;  // + alignment
};

struct Params {
  const int8_t* x;
  const int8_t* w;
  uint8_t* out;        // the bus (one part)
  int32_t* ws;         // [parts, M, N] partial sums (several parts), or null
  int M, N, K;
  int spp;             // k steps of kBK a part
  const int32_t* regs;
  int num_exponents, qmin, qmax;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset, within a 1024-byte-aligned tile, of logical offset `off`
// under CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk (bits 4-6) XOR the
// 128-byte row (bits 7-9)
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & 0x70u);
}

// 4 x 4 byte transpose of rows read in the order (rot = 0) 0, 1, 2, 3 or
// (rot = 1) 2, 3, 0, 1: l[i] holds columns 0..3 (column 0 in the low byte)
// of one row; col[j] gets column j's bytes of rows 0..3 (row 0 low). The
// rotation is undone by the last step's selectors, `lo` / `hi` = 0x5410 /
// 0x7632, or 0x1054 / 0x3276 when rotated.
__device__ __forceinline__ void transpose4(const uint32_t (&l)[4], uint32_t lo,
                                           uint32_t hi, uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(l[0], l[1], 0x5140);
  const uint32_t t1 = __byte_perm(l[2], l[3], 0x5140);
  const uint32_t t2 = __byte_perm(l[0], l[1], 0x7362);
  const uint32_t t3 = __byte_perm(l[2], l[3], 0x7362);
  col[0] = __byte_perm(t0, t1, lo);
  col[1] = __byte_perm(t0, t1, hi);
  col[2] = __byte_perm(t2, t3, lo);
  col[3] = __byte_perm(t2, t3, hi);
}

// The A fragments of k step `ks` (32 k) of a stage for both m64 tiles:
// rows 32 ks + 16 kh + 4 t + i of the thread's w box (128-byte rows), 4
// columns from byte `wcol`. Tile T's rows g / g + 8 are the thread's
// columns 2T / 2T + 1; registers 0, 1 hold k-quad t, registers 2, 3 k-quad
// t + 4. Under the 128-byte swizzle the rows 4t + i of threads t and t + 2
// would share a bank; lanes with t >= 2 read their 4 rows rotated by 2
// (`rot`), so each of the 8 loads is conflict-free.
__device__ __forceinline__ void build_a(const unsigned char* wp, int ks,
                                        int t, int rot, uint32_t lo,
                                        uint32_t hi, uint32_t wcol,
                                        uint32_t (&a)[2][4]) {
  uint32_t col[2][4];
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    uint32_t l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      l[i] = *reinterpret_cast<const uint32_t*>(
          wp + swz((32 * ks + 16 * kh + 4 * t + ((i + 2 * rot) & 3)) * 128 +
                   wcol));
    transpose4(l, lo, hi, col[kh]);
  }
#pragma unroll
  for (int T = 0; T < 2; ++T) {
    a[T][0] = col[0][2 * T];
    a[T][1] = col[0][2 * T + 1];
    a[T][2] = col[1][2 * T];
    a[T][3] = col[1][2 * T + 1];
  }
}

template <int BM>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BM / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BM == 32) wgmma_s8_rs_n32(d, a, db);
  else wgmma_s8_rs_n128(d, a, db);
}

// The producer's fallback for shapes TMA does not take: the stage's x and
// w tiles written by the producer warpgroup's 128 threads, a byte at a
// time, in the layout TMA gives (zeros past M, N and K).
template <int BM>
__device__ void load_stage_bytes(const Params& p, unsigned char* sx, int m0,
                                 int n0, int k0, int pt) {
  for (int q = pt; q < BM * kBK / 4; q += 128) {
    const int r = q >> 5, kw = q & 31, m = m0 + r;
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = k0 + 4 * kw + b;
      if (m < p.M && k < p.K)
        word |= (uint32_t)(uint8_t)p.x[(int64_t)m * p.K + k] << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(sx + swz(r * kBK + 4 * kw)) = word;
  }
  unsigned char* sw = sx + Cfg<BM>::kX;
  for (int q = pt; q < kWStage / 4; q += 128) {
    const int pn = q >> 12, r = (q >> 5) & (kBK - 1), cw = q & 31;
    const int k = k0 + r, n = n0 + kWBox * pn + 4 * cw;
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (k < p.K && n + b < p.N)
        word |= (uint32_t)(uint8_t)p.w[(int64_t)k * p.N + n + b] << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(sw + pn * kWPanel +
                                 swz(r * kWBox + 4 * cw)) = word;
  }
}

template <int BM, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
matmul_grau_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const Params p) {
  using C = Cfg<BM>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int4 table[GRAU_MAX_SEGMENTS];   // the unit's segment rows
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + C::kBar, empty0 = full0 + 8 * S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int steps = p.K > 0 ? (p.K + kBK - 1) / kBK : 1;
  const int first = blockIdx.z * p.spp;
  const int n_steps = min(steps, first + p.spp) - first;   // >= 1 (host)

  if (tid < GRAU_MAX_SEGMENTS)
    grau_table_fill(table, grau_unit_load(p.regs, p.num_exponents, p.qmin,
                                          p.qmax), tid);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ----- producer -----
    setmaxnreg_dec<kProducerRegs>();
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % S;
      const uint32_t full = full0 + 8 * s, sx = base + s * C::kStage;
      const int k0 = (first + it) * kBK;
      if constexpr (kTma) {
        if (tid != 0) break;
        mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
        mbar_expect_tx(full, C::kStage);
        tma_load_2d(sx, &xmap, full, k0, m0);
#pragma unroll
        for (int pn = 0; pn < 2; ++pn)
          tma_load_2d(sx + C::kX + pn * kWPanel, &wmap, full,
                      n0 + kWBox * pn, k0);
      } else {
        mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
        load_stage_bytes<BM>(p, sm + s * C::kStage, m0, n0, k0, tid);
        fence_proxy_async();   // the x tile is read by wgmma
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (tid == 0) mbar_arrive(full);
      }
    }
    return;
  }

  // ----- consumers: 128 w columns each -----
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's w columns: n0 + 128 c + 32 warp + 4 g + (0..3), in box c
  // at byte 32 warp + 4 g
  const int wpanel = C::kX + c * kWPanel;
  const uint32_t wcol = 32 * warp + 4 * g;
  const int rot = t >> 1;
  const uint32_t lo = rot ? 0x1054u : 0x5410u, hi = rot ? 0x3276u : 0x7632u;

  int32_t acc[2][BM / 2];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[T][i] = 0;
  uint32_t a[2][2][4];         // two sets of A fragments, k steps alternate

  for (int it = 0; it < n_steps; ++it) {
    const int s = it % S;
    mbar_wait(full0 + 8 * s, (it / S) & 1);
    const unsigned char* wp = sm + s * C::kStage + wpanel;
    const uint32_t xs = base + s * C::kStage;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      build_a(wp, ks, t, rot, lo, hi, wcol, a[ks & 1]);
#pragma unroll
      for (int T = 0; T < 2; ++T) {
        fence_regs(a[ks & 1][T]);   // every A register defined before the
        fence_regs(acc[T]);         // fence, none between the products
      }
      wgmma_fence();
      const uint64_t db = desc_sw128(xs + 32 * ks);
      wgmma_s8<BM>(acc[0], a[ks & 1][0], db);
      wgmma_s8<BM>(acc[1], a[ks & 1][1], db);
      wgmma_commit();
      if (ks + 1 < kBK / 32) wgmma_wait<1>();   // the previous k step
    }
    // the stage's products retire before it is released (and before the
    // next full-barrier wait: a wait inside an open wgmma pipeline makes
    // ptxas serialize every product)
    wgmma_wait<0>();
    mbar_arrive(empty0 + 8 * s);
  }
#pragma unroll
  for (int T = 0; T < 2; ++T) fence_regs(acc[T]);

  // outputs: x row m0 + 8 j + 2 t + e holds w columns nb .. nb + 3 as
  // acc[0][4j + e], acc[0][4j + 2 + e], acc[1][4j + e], acc[1][4j + 2 + e]
  const int nb = n0 + 128 * c + 32 * warp + 4 * g;
  const bool vec = (p.N & 3) == 0;          // nb + 3 < N then as well
  if (p.ws != nullptr) {
    // a K part: the int32 partial sums to the workspace
    if (nb >= p.N) return;
    int32_t* ws = p.ws + (int64_t)blockIdx.z * p.M * p.N;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= p.M) continue;
        const int32_t v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                              acc[1][4 * j + e], acc[1][4 * j + 2 + e]};
        int32_t* o = ws + (int64_t)m * p.N + nb;
        if (vec) {
          *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (nb + q < p.N) o[q] = v[q];
        }
      }
    return;
  }
  // the whole sum: staged through the (now idle) ring as this consumer's
  // BM x 128 int32 tile, rows padded to kStRow bytes (the 4 rows a warp's
  // 16-byte stores hit then fall in different banks), then the datapath in
  // a rolled loop (one copy of its code: unrolled over 128 sums a thread
  // it overflows the instruction cache), a warp on 32 x 4 columns of a row
  named_sync(2);                     // both consumers are done with the ring
  int32_t* st = reinterpret_cast<int32_t*>(sm + c * BM * kStRow);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<int4*>(st + (8 * j + 2 * t + e) * (kStRow / 4) +
                               32 * warp + 4 * g) =
          make_int4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                    acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
  const GrauUnit u = grau_unit_load(p.regs, p.num_exponents, p.qmin, p.qmax);
#pragma unroll 1
  for (int q = lt; q < BM * 32; q += 128) {
    const int r = q >> 5, m = m0 + r, n = n0 + 128 * c + 4 * (q & 31);
    if (m >= p.M || n >= p.N) continue;
    const uint32_t word = grau_eval4(
        u, table,
        *reinterpret_cast<const int4*>(st + r * (kStRow / 4) + 4 * (q & 31)));
    uint8_t* o = p.out + (int64_t)m * p.N + n;
    if (vec) {
      *reinterpret_cast<uint32_t*>(o) = word;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (n + b < p.N) o[b] = (uint8_t)(word >> (8 * b));
    }
  }
}

// Sums the K parts' int32 partials (modulo 2^32) and runs the datapath once
// per output: 4 outputs a thread from 16-byte loads when N % 4 == 0.
__global__ void __launch_bounds__(256)
combine_kernel(const int32_t* __restrict__ ws, uint8_t* __restrict__ out,
               int parts, int64_t mn, int N, const int32_t* __restrict__ regs_g,
               int num_exponents, int qmin, int qmax) {
  __shared__ int4 table[GRAU_MAX_SEGMENTS];
  const GrauUnit u = grau_unit_load(regs_g, num_exponents, qmin, qmax);
  grau_table_fill(table, u, threadIdx.x);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((N & 3) == 0) {
    const int64_t n4 = mn >> 2;
    const int4* w4 = reinterpret_cast<const int4*>(ws);
    for (int64_t i = tid; i < n4; i += stride) {
      int4 s = w4[i];
      for (int pi = 1; pi < parts; ++pi) {
        const int4 v = w4[pi * n4 + i];
        s.x = (int32_t)((uint32_t)s.x + (uint32_t)v.x);
        s.y = (int32_t)((uint32_t)s.y + (uint32_t)v.y);
        s.z = (int32_t)((uint32_t)s.z + (uint32_t)v.z);
        s.w = (int32_t)((uint32_t)s.w + (uint32_t)v.w);
      }
      reinterpret_cast<uint32_t*>(out)[i] = grau_eval4(u, table, s);
    }
  } else {
    for (int64_t i = tid; i < mn; i += stride) {
      uint32_t s = 0u;
      for (int pi = 0; pi < parts; ++pi) s += (uint32_t)ws[pi * mn + i];
      out[i] = (uint8_t)grau_eval(u, (int32_t)s);
    }
  }
}

// An int8 (rows, cols) row-major matrix as a 2-D tensor map of boxes of
// `box_cols` x `box_rows`, 128-byte swizzled; reads past its edges are
// zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)base, dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, bool kTma>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const Params& p,
           int parts, cudaStream_t s) {
  using C = Cfg<BM>;
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_grau_kernel<BM, kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + BM - 1) / BM, parts);
  matmul_grau_kernel<BM, kTma><<<grid, kThreads, C::kSmem, s>>>(xm, wm, p);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bm(bool tma, const CUtensorMap& xm, const CUtensorMap& wm,
              const Params& p, int parts, cudaStream_t s) {
  return tma ? launch<BM, true>(xm, wm, p, parts, s)
             : launch<BM, false>(xm, wm, p, parts, s);
}

}  // namespace

// x (M, K) and w (K, N) int8, contiguous; out (M, N) bytes. `bm` (32 or
// 128) rows of x a block, `parts` K parts of `spp` steps of 128 k (the
// wrapper's plan); with parts > 1, `ws` is an int32 workspace of parts * M
// * N. `sms` sizes the combine's grid.
extern "C" int matmul_grau_launch(const void* x, const void* w, void* out,
                                  void* ws, int M, int N, int K, int bm,
                                  int parts, int spp, const void* regs,
                                  int num_exponents, int qmin, int qmax,
                                  int sms, void* stream) {
  if (M < 0 || N < 0 || K < 0 || parts < 1 || spp < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int steps = K > 0 ? (K + kBK - 1) / kBK : 1;
  if ((long long)(parts - 1) * spp >= steps || (long long)parts * spp < steps ||
      (parts > 1 && ws == nullptr) || (M + bm - 1) / bm > 65535 ||
      parts > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{(const int8_t*)x, (const int8_t*)w, (uint8_t*)out,
                 parts > 1 ? (int32_t*)ws : nullptr, M, N, K, spp,
                 (const int32_t*)regs, num_exponents, qmin, qmax};
  const bool tma = K % 16 == 0 && N % 16 == 0 && K > 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  CUtensorMap xm{}, wm{};
  if (tma && (!make_map(&xm, x, M, K, kBK, bm) ||
              !make_map(&wm, w, K, N, kWBox, kBK)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (bm) {
    case 32: err = launch_bm<32>(tma, xm, wm, p, parts, s); break;
    case 128: err = launch_bm<128>(tma, xm, wm, p, parts, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || parts == 1) return err;
  const long long mn = (long long)M * N;
  const long long work = (N % 4 == 0 ? mn / 4 : mn);
  long long blocks = (work + 255) / 256;
  if (blocks > (long long)sms * 8) blocks = (long long)sms * 8;
  combine_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      (const int32_t*)ws, (uint8_t*)out, parts, mn, N, (const int32_t*)regs,
      num_exponents, qmin, qmax);
  return (int)cudaGetLastError();
}
