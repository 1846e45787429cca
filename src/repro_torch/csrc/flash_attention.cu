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
// (0.015 ms at 3.35 TB/s). Only wgmma reaches the tensor cores' full rate,
// and it wants 64-row operands in shared memory fed without the threads'
// help: that is the bf16 design below.
//
// Kernels, chosen by the launcher from dtype and head_dim (never on a
// failure):
//   * bf16, head_dim 64, 128, 192, 256: flash_wgmma_kernel. A block of three
//     warpgroups covers 128 query rows of one (batch row, head): warpgroup
//     0 is the producer (setmaxnreg down to 24 registers; one thread issues
//     every load), warpgroups 1 and 2 the consumers (setmaxnreg up to 240),
//     64 query rows each. Q and the K/V tiles arrive by TMA from tensor maps
//     over the strided (b, s, heads, d) views (made on the host with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda), 128-byte swizzled in panels of 64
//     columns; K/V through a ring of tiles of 128 keys (64 above head_dim
//     128, so that the ring, Q and the accumulators fit), 3 stages (2 at
//     head_dim 256: 225 KB of shared memory at 128, 193 KB at 256), with
//     full/empty mbarriers.
//     S = Q K^T is one wgmma chain per tile with Q and K in shared memory
//     (f32 accumulators, m64 x 128 keys); the online softmax runs in the
//     accumulators' registers (exp2, the scale folded into its FMA: the
//     kernel takes scale > 0, which the wrapper checks); P is rounded to
//     bf16 in registers and O += P V is a wgmma chain with P from
//     registers and V from shared memory as the MN-major operand (no
//     transpose copy), one m64 x head_dim product per 16 keys. The
//     producer waits on a stage's empty barrier, the consumers on its full
//     one. Each consumer is pipelined one tile deep: it issues S of tile
//     j + 1, then P V of tile j, waits for S only and runs tile j + 1's
//     softmax (the exponentials, about half the tensor cores' time a tile)
//     while P V of tile j is still on the tensor cores; and the two
//     consumers take turns issuing products (pingpong on named barriers),
//     so one's softmax runs under the other's products. Only tiles that
//     cross a consumer's diagonal (or the ragged s_kv edge) are masked;
//     tiles wholly above the block's diagonal are never loaded. Query tiles
//     are issued heaviest first, and
//     the heads of a KV head next to each other (blockIdx.x runs over
//     heads), so their K/V tiles are read from L2.
//   * bf16, head_dim 16, 32, 48: flash_mma_kernel (wgmma's 64-column
//     panels and 128-byte rows do not fit these widths): one block of 4
//     warps per (64 query rows, batch row x head); each warp owns 16 rows.
//     Q, and K and V tiles of 64 keys, are staged in shared memory by
//     cp.async (K/V double-buffered), rows padded by 16 bytes. S = Q K^T
//     and O += P V on mma.sync m16n8k16 (f32 accumulators), V's B fragments
//     from ldmatrix.trans; P rounded to bf16 before P V (its row sum l stays
//     f32); query tiles heaviest first.
//   * f32, every head_dim: flash_f32_kernel, in f32 on the FMA units (no
//     TF32): one block of 4 warps per (16 query rows, batch row x head),
//     K/V tiles of 32 keys in shared memory; a warp walks its 4 rows, lane
//     j scoring key j, and each lane accumulates output columns lane, lane
//     + 32, ... (< d).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16, head_dim 64..256: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kWgRows = 128;      // query rows a block (64 a consumer)
constexpr size_t kMaxSmem = 232448;

template <int D>
struct WgTiles {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int BKV = D <= 128 ? 128 : 64;   // keys a tile
  static constexpr int kPanel = 64 * 128;           // Q panel: 64 rows
  static constexpr int kQ = P * kPanel;             // one consumer's Q
  static constexpr int kKVPanel = BKV * 128;
  static constexpr int kKV = P * kKVPanel;          // K or V of a stage
  // a consumer needs tile j + 1 while tile j is in use and tile j - 1 is
  // being released: 3 stages leave the producer a tile of slack (all but
  // head_dim 256, where 2 fit). Q of both consumers, the ring, then the
  // barriers; + 1024 to align.
  static constexpr int kStages =
      2 * (size_t)kQ + 3 * 2 * (size_t)kKV + 8 * 7 + 1024 <= kMaxSmem ? 3 : 2;
  static constexpr int kBarrier = 2 * kQ + kStages * 2 * kKV;
  static constexpr size_t kSmem =
      (size_t)kBarrier + 8 * (1 + 2 * kStages) + 1024;
  static_assert(D % 64 == 0 && kSmem <= kMaxSmem, "shared memory");
};

// One consumer warpgroup's steps over the K/V ring (inlined: the register
// arrays they take stay in registers).
template <int D>
struct Tile {
  using L = WgTiles<D>;
  static constexpr int BKV = L::BKV, P = L::P;
  int skv, causal, q_offset;
  uint32_t sQc, sKV, full0;   // this consumer's Q, the ring, full barriers
  int first, row0, t;         // first position, this thread's row, t
  float sl2;                  // scale * log2(e)

  // waits until tile `it`'s stage has landed
  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(full0 + 8 * (it % L::kStages), (it / L::kStages) & 1);
  }
  // S = Q K^T of tile `it` into sc (after wait_full and wgmma_fence)
  __device__ __forceinline__ void issue_s(float (&sc)[BKV / 2], int it) const {
    const uint32_t sK = sKV + (it % L::kStages) * 2 * L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;   // 16 values into the row
      const uint64_t da = desc_sw128(sQc + (kk >> 2) * L::kPanel + off);
      const uint64_t db = desc_sw128(sK + (kk >> 2) * L::kKVPanel + off);
      if constexpr (BKV == 128) wgmma_ss_n128(sc, da, db, kk > 0);
      else wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit();
  }
  // O += P V of tile `it`: 16 keys a step, all of head_dim a product
  __device__ __forceinline__ void issue_pv(float (&o)[P][32],
                                           const uint32_t (&pa)[BKV / 16][4],
                                           int it) const {
    const uint32_t sV = sKV + (it % L::kStages) * 2 * L::kKV + L::kKV;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db = desc_sw128_mn(sV + kk * 16 * 128, L::kKVPanel);
      if constexpr (D == 64) wgmma_rs_n64_mn(o, pa[kk], db);
      else if constexpr (D == 128) wgmma_rs_n128_mn(o, pa[kk], db);
      else if constexpr (D == 192) wgmma_rs_n192_mn(o, pa[kk], db);
      else wgmma_rs_n256_mn(o, pa[kk], db);
    }
    wgmma_commit();
  }
  // The online softmax of tile `it` in sc: mask (raw scores), then the max
  // and e^(s - m) in log2 units with the scale folded into the exponent's
  // FMA (scale > 0, so the raw max is the scaled one); sc[4j + i] is row g
  // + 8 (i >> 1), key kv0 + 8j + 2t + (i & 1). Leaves e^(s - m) in sc,
  // updates m and l, and returns O's rescale in alpha. (One pass less over
  // the scores than scaling first: 0.28 -> 0.19 ms at the training shape
  // with the wide P V, on an H100 SXM.)
  __device__ __forceinline__ void softmax(float (&sc)[BKV / 2], float (&m_r)[2],
                                          float (&l_r)[2], float (&alpha)[2],
                                          int it) const {
    const int kv0 = it * BKV;
    const bool mask = kv0 + BKV > skv || (causal && kv0 + BKV - 1 > first);
    float mx[2] = {kNegInf, kNegInf};
    if (mask) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kv0 + 8 * j + 2 * t + (i & 1);
          const int qpos = q_offset + row0 + 8 * (i >> 1);
          if (key >= skv || (causal && key > qpos)) sc[4 * j + i] = kNegInf;
        }
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[4 * j + i]);
    float msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * sl2);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      msc[r] = -m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp2f(fmaf(sc[4 * j + i], sl2, msc[i >> 1]));
        sc[4 * j + i] = e;
        ls[i >> 1] += e;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ls[r];
  }
};

// O *= alpha, and P (in sc) rounded to bf16 into the A fragments: keys
// 16 kk .. 16 kk + 15 are sc's 8-key groups 2 kk and 2 kk + 1
template <int D>
__device__ __forceinline__ void rescale_and_pack(
    float (&o)[D / 64][32], uint32_t (&pa)[WgTiles<D>::BKV / 16][4],
    const float (&sc)[WgTiles<D>::BKV / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[pn][4 * j] *= alpha[0];
      o[pn][4 * j + 1] *= alpha[0];
      o[pn][4 * j + 2] *= alpha[1];
      o[pn][4 * j + 3] *= alpha[1];
    }
#pragma unroll
  for (int j = 0; j < WgTiles<D>::BKV / 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, Params p) {
  using L = WgTiles<D>;
  constexpr int BKV = L::BKV, P = L::P;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const uint32_t raw = smem_addr(smem_wg);
  const uint32_t base = (raw + 1023) & ~1023u;     // 128-byte swizzle atoms
  const uint32_t sQ = base, sKV = base + 2 * L::kQ;
  const uint32_t qbar = base + L::kBarrier;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * L::kStages;

  const int tid = threadIdx.x, wg = tid / 128;
  const int hi = blockIdx.x % p.h, bi = blockIdx.x / p.h;
  const int kh = hi / (p.h / p.kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;   // heaviest first
  const int n_tiles = (kv_limit(p, q0, kWgRows) + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ----- producer: one thread issues every TMA load -----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * L::kQ);
      for (int c = 0; c < 2; ++c)
        for (int pn = 0; pn < P; ++pn)
          tma_load_4d(sQ + c * L::kQ + pn * L::kPanel, &qmap, qbar, 64 * pn,
                      q0 + 64 * c, hi, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty0 + 8 * s, ((it / L::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t sK = sKV + s * 2 * L::kKV, sV = sK + L::kKV;
        mbar_expect_tx(full, 2 * L::kKV);
        for (int pn = 0; pn < P; ++pn) {
          tma_load_4d(sK + pn * L::kKVPanel, &kmap, full, 64 * pn, it * BKV,
                      kh, bi);
          tma_load_4d(sV + pn * L::kKVPanel, &vmap, full, 64 * pn, it * BKV,
                      kh, bi);
        }
      }
    }
  } else {
    // ----- consumers: 64 query rows each -----
    setmaxnreg_inc<240>();
    const int c = wg - 1, lt = tid - 128 * wg;       // thread in warpgroup
    const int warp = lt >> 5, lane = lt & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * c + 16 * warp + g;    // rows row0, row0 + 8
    const int first = p.q_offset + q0 + 64 * c;      // first row's position
    const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
    const uint32_t sQc = sQ + c * L::kQ;

    float o[P][32];
#pragma unroll
    for (int pn = 0; pn < P; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};   // running max, log2 units
    float l_r[2] = {0.f, 0.f};           // this thread's part of the row sums

    float sc[BKV / 2];          // S of one tile, then its e^(s - m)
    uint32_t pa[BKV / 16][4];   // P as bf16 A fragments, 16 keys a step
    float alpha[2];
    const Tile<D> tile{p.skv, p.causal, p.q_offset, sQc, sKV, full0,
                       first, row0, t, sl2};
    // Every wgmma below is issued right after a wgmma.fence, with no
    // branch or barrier wait between: ptxas otherwise injects a fence of
    // its own on a divergent path and serializes the products.
    // Pingpong: the two consumers take turns issuing their products (named
    // barriers 1 and 2, 256 threads), so one's softmax runs under the
    // other's products. Both take n_tiles + 1 turns; consumer 1 arrives
    // once up front and skips its last arrive, so every arrive is waited.
    const int mine_bar = 1 + c, other_bar = 2 - c;
    if (c == 1) named_arrive(1);          // consumer 0 goes first
    mbar_wait(qbar, 0);
    tile.wait_full(0);
    named_sync(mine_bar);
    wgmma_fence();
    tile.issue_s(sc, 0);
    named_arrive(other_bar);
    wgmma_wait<0>();
    fence_regs(sc);
    tile.softmax(sc, m_r, l_r, alpha, 0);
    rescale_and_pack<D>(o, pa, sc, alpha);
    // pipelined: S of tile it + 1 and its exponentials run while the
    // tensor cores do P V of tile it
    for (int it = 0; it + 1 < n_tiles; ++it) {
      tile.wait_full(it + 1);
#pragma unroll
      for (int pn = 0; pn < P; ++pn) fence_regs(o[pn]);
      named_sync(mine_bar);
      wgmma_fence();
      tile.issue_s(sc, it + 1);
      tile.issue_pv(o, pa, it);
      named_arrive(other_bar);
      wgmma_wait<1>();            // S of tile it + 1 (the older group)
      fence_regs(sc);
      tile.softmax(sc, m_r, l_r, alpha, it + 1);
      wgmma_wait<0>();            // P V of tile it
#pragma unroll
      for (int pn = 0; pn < P; ++pn) fence_regs(o[pn]);
      mbar_arrive(empty0 + 8 * (it % L::kStages));
      rescale_and_pack<D>(o, pa, sc, alpha);
    }
#pragma unroll
    for (int pn = 0; pn < P; ++pn) fence_regs(o[pn]);
    named_sync(mine_bar);
    wgmma_fence();
    tile.issue_pv(o, pa, n_tiles - 1);
    if (c == 0) named_arrive(other_bar);    // consumer 1's last turn is final
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < P; ++pn) fence_regs(o[pn]);
    mbar_arrive(empty0 + 8 * ((n_tiles - 1) % L::kStages));

    // o / l in bf16 at (row, 64 pn + 8 j + 2 t), lse = m ln 2 + log l
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
      for (int pn = 0; pn < P; ++pn)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 64 * pn + 8 * j + 2 * t) =
              pack_bf16(o[pn][4 * j + 2 * r] * inv,
                        o[pn][4 * j + 2 * r + 1] * inv);
      if (t == 0)
        p.lse[((long long)bi * p.h + hi) * p.sq + row] =
            m_r[r] * 0.6931471805599453f + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, head_dim 16..48: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;    // query rows a block
constexpr int kBKV = 64;   // keys a tile

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)5 * 64 * (D + 8) * sizeof(__nv_bfloat16);   // Q, 2 K, 2 V
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

// (the minimum of one block an SM lets ptxas use the registers it needs:
// with the thread count alone it spilled 4 and 12 bytes at head_dim 48 and
// 16)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(Params p) {
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
  constexpr int E = (D + 31) / 32;                // output columns a lane
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
          if (D % 32 == 0 || lane + 32 * e < D)   // D 16, 48: a ragged lane
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
    for (int e = 0; e < E; ++e)
      if (D % 32 == 0 || lane + 32 * e < D) orow[lane + 32 * e] = acc[rr][e] / den;
    if (lane == 0)
      p.lse[((long long)bi * p.h + hi) * p.sq + row] = m[rr] + logf(l[rr]);
  }
}

// A bf16 (batch, seq, heads, d) view with element strides (sb, ss, sh) as a
// 4-D tensor map of boxes of 64 columns x `rows` rows, 128-byte swizzled;
// rows past seq read as zeros.
bool make_map(CUtensorMap* map, const void* base, int d, int seq, int heads,
              int batch, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using L = WgTiles<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, p.q, D, p.sq, p.h, p.b, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !make_map(&km, p.k, D, p.skv, p.kvh, p.b, p.k_sb, p.k_ss, p.k_sh,
                L::BKV) ||
      !make_map(&vm, p.v, D, p.skv, p.kvh, p.b, p.v_sb, p.v_ss, p.v_sh,
                L::BKV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.b * p.h, (p.sq + kWgRows - 1) / kWgRows);
  flash_wgmma_kernel<D><<<grid, kWgThreads, L::kSmem, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.b * p.h);
  flash_mma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kF32Rows - 1) / kF32Rows, p.b * p.h);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Params& p, bool bf16, cudaStream_t stream) {
  if (!bf16) return launch_f32<D>(p, stream);
  if constexpr (D % 64 == 0) return launch_wgmma<D>(p, stream);
  else return launch_mma<D>(p, stream);
}

}  // namespace

// dtype: 0 f32, 1 bf16. Strides in elements; the last dimension of q, k and
// v is contiguous, and every row (and the bases) starts on 16 bytes (bf16
// at head_dim 64..256: the tensor maps also need every stride a multiple of
// 16 bytes). bf16 head_dims 64, 128, 192, 256 run the wgmma kernel, 16, 32
// and 48 the mma.sync kernel; f32 runs the FMA kernel at every head_dim.
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
    case 16: return launch<16>(p, bf16, s);
    case 32: return launch<32>(p, bf16, s);
    case 48: return launch<48>(p, bf16, s);
    case 64: return launch<64>(p, bf16, s);
    case 128: return launch<128>(p, bf16, s);
    case 192: return launch<192>(p, bf16, s);
    case 256: return launch<256>(p, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
