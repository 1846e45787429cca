// Paged attention through the block table for Hopper (sm_90a), bf16
// queries, on the bf16 tensor cores, with the GRAU epilogue optionally
// fused: chunked (multi-query) prefill, and one-token decode as its C = 1
// case, both split over the sequence.
//
// Replaces: the JAX package's kernels/paged_attention.py
//   * _paged_prefill_jit (via paged_prefill_attention)  -> attend_kernel<., 1>
//   * _paged_attention_jit (via paged_attention)        -> attend_kernel<., 4>
// for bf16 queries, over 16-bit (bf16), 8-bit and 4-bit KV pools. f32
// queries (f32 pools) stay on paged_attention.cu's attend_rows: the
// wrapper dispatches by dtype, not on failure. Decode lives here, beside
// the prefill, because it is the same function at C = 1 and needs the same
// pieces (ring, exact dequant, tensor-core products, part combine); only
// the split of a block's warps differs.
//
// What it computes (the same function as attend_rows): for batch row b and
// KV head kh, the R = C * g query rows (chunk row c, group member gi) that
// share kh attend pool positions through table[b, :]; row (c, gi) sees
// positions <= start[b] + c (decode: start = length - 1, C = 1). The live
// blocks are max(cdiv(start + C, bs), 1), never past the table width;
// logits are scale * q.k, NEG_INF = -1e30 (finite) on masked live
// positions, -inf past the live blocks, and the output is o / max(l,
// 1e-30). An idle slot (length 0) reads block table[b, 0], every position
// masked, and stays finite. With the epilogue the f32 output is scaled by
// inv_s, rounded half to even with saturation and pushed through the GRAU
// datapath (grau_datapath.cuh).
//
// Bound on the H100: memory bytes. One 32-token chunk of llama3.2-3b (24
// heads over 8 KV heads of 128) at a 1024-position prefix reads 4.2 MB of
// bf16 K/V (1 MB at 4 bits): 1.3 us (0.3 us) at 3.35 TB/s, against 0.4
// GFLOP of products, 0.4 us at the bf16 tensor-core peak (P V in three
// bf16 parts makes it 0.8 GFLOP); the same products take 6 us on the FMA
// units. Decode at 8 slots ragged to 2048 reads ~23 MB of bf16 K/V (6.8 us)
// for 3 flops a byte: the tensor cores idle either way, and the time is the
// bytes in flight against the load latency.
//
// Design:
//   * Grid: (sequence parts) x (KV head x row groups) x (batch row). Parts
//     are runs of whole table blocks cut from the table width on the host
//     (never from `start` / `lengths`, which live on the device, so a launch
//     is capturable in a CUDA graph): prefill_plan / decode_plan in
//     kernels/paged_attention.py. Each block finds its live range from
//     start on the device and returns at once when its part lies past the
//     live blocks.
//   * Warps: PW position warps x up to 8 / PW row warps. Prefill (PW = 1):
//     a block holds up to 128 of the C * g query rows of its KV head (96 at
//     the main shape, 6 warps of 16 rows), so K and V are read and
//     dequantized once per head, not once per 16-row tile; each warp walks
//     every position of a tile. Decode (PW = 4): the g <= 16 query rows of a
//     KV head are one m16 fragment (13 of 16 rows padding at g = 3), and the
//     4 warps of a block each take 16 of a tile's 64 positions with the same
//     rows, so all 128 threads issue loads and all 4 warps do products;
//     after the walk the 4 warps' (o, m, l) are merged in shared memory in
//     warp order. decode_plan cuts the 128-block table of the main shape
//     into parts of 16 blocks (256 positions): 8 parts x 8 KV heads x 8
//     slots = 512 blocks, ~4 an SM, before the ragged lengths idle some.
//   * Loads: K and V pool rows come through the table into a 3-stage
//     cp.async ring of 64-position tiles (32 for the prefill above head_dim
//     128) as raw bytes in their stored width, spread over every thread of
//     the block: 16-byte copies, or 8-byte ones where a pool row is not a
//     whole number of 16-byte vectors (4-bit rows at head_dim 16 and 48: 8
//     and 24 bytes). 16-bit pools are used in place (rows padded 16 bytes
//     against bank conflicts), 8- and 4-bit pools are dequantized once to a
//     bf16 tile in shared memory with the block's 2^e, exactly (q * 2^e fits
//     bf16).
//   * QK^T: mma.sync m16n8k16, bf16 in, f32 out (the products are exact).
//     The tensor cores align a sum to its largest addend and truncate, so
//     each 16-deep product goes into a zeroed fragment and is added to the
//     running logits in f32 (round to nearest): the truncation then scales
//     with one step's products, not the running sum. Online softmax in f32
//     registers, in the fragment layout of flash_attention.cu's mma.sync
//     kernel. Decode uses the tensor cores too although it is 3 flops a
//     byte: one m16 fragment does the g rows' products in a few
//     instructions, and the path is the prefill's, checked bit for bit
//     against the same rounding rules.
//   * P V: P is split into bf16 hi + mid + lo (p - hi - mid - lo <= 2^-27
//     p) and each part goes through the tensor cores against V
//     (ldmatrix.trans). P rounded once to bf16 would be 2^-9 off; hi + lo
//     alone (2^-18 p) left the f32 output up to 3.5e-6 off in an emulation
//     with truncating accumulation, and on the card one near-zero bf16
//     output fell outside the one-ulp gate (1e-6 + 2^-7 |want|); with three
//     parts the emulation stays within 8.4e-7. Each 16-position step's three
//     products go into zeroed fragments that are then added to O in f32,
//     as for QK^T. l is the f32 sum of P.
//   * Parts: each block writes its (o, m, l) to an f32 workspace and a
//     second launch from the same C entry combines the live parts in part
//     order: m = max m_p, l = sum l_p e^(m_p - m), o = sum o_p e^(m_p - m),
//     out = o / max(l, 1e-30), then the output cast or the GRAU epilogue,
//     over R x d / 4 threads. With one part this is o_0 / max(l_0, 1e-30).
//     A single part goes through the combine too: storing from the main
//     kernel's few blocks (8 at one part) took ~30 us more a call in the
//     served slices, ~57 us more with the epilogue. Part 0 always holds
//     position 0, which every row sees, so m is a real score and a part
//     past a row's horizon (all its logits -1e30) weighs exactly 0, as the
//     masked positions do in one pass. Two CUDA launches a call, prefill or
//     decode.
//   * Head dims: any multiple of 16 (the mma's depth); instantiated for
//     16, 32, 48, 64, 128, 192 and 256, the head dims of the reference's
//     archs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kMaxWarps = 8;                 // warps a block, at most
constexpr int kStages = 3;
constexpr int kDecodeWarps = 4;              // decode: position warps a block
constexpr float kNegInf = -1e30f;

enum PoolKind { kPoolBF16 = 1, kPoolQ8 = 2, kPoolQ4 = 3 };

struct Args {
  const __nv_bfloat16* q;     // (batch, C, h, D)
  const uint8_t* k;           // pools as bytes
  const uint8_t* v;
  const int8_t* k_exp;        // (num_blocks, kvh), quantized pools only
  const int8_t* v_exp;
  const int32_t* table;
  int table_stride;
  const int32_t* starts;      // (batch,): chunk starts, or decode lengths
  int start_off;              // start = starts[b] - start_off (decode: 1)
  void* out;                  // (batch, C, h, D)
  float* ws_o;                // (batch, kvh, parts, R, D)
  float2* ws_ml;              // (batch, kvh, parts, R) of (m, l)
  int C, h, kvh, bs, nblocks, parts, bpp;
  float scale;
  int out_kind;
  Epilogue epi;
};

// Shared-memory plan of attend_kernel<KIND, D, PW>.
template <int KIND, int D, int PW>
struct Tiles {
  static constexpr int TP =                       // positions a tile
      PW == 1 && D > 128 ? 32 : 64;
  static constexpr int TPW = TP / PW;             // positions a warp's step
  static constexpr int GROUP = 16 * (kMaxWarps / PW);   // query rows a block
  static constexpr int S = D + 8;                 // bf16 tile row (elements)
  static constexpr int ROW =                      // pool bytes a position row
      KIND == kPoolBF16 ? 2 * D : KIND == kPoolQ8 ? D : D / 2;
  static constexpr int CB = ROW % 16 == 0 ? 16 : 8;   // bytes a copy
  static constexpr int CH = ROW / CB;             // copies a position row
  static constexpr int RAW = KIND == kPoolBF16 ? 2 * S : ROW;   // ring row
  static constexpr int kRaw = TP * RAW;           // K or V of a ring slot
  static constexpr int kBf = TP * S * 2;          // one dequantized tile
  static_assert(D % 16 == 0 && TPW % 16 == 0, "mma shapes");
  static size_t smem(int qrows, int warps) {
    const size_t q = (size_t)qrows * S * 2;
    const size_t walk = (size_t)kStages * 2 * kRaw +
                        (KIND == kPoolBF16 ? 0 : 2 * (size_t)kBf);
    // decode: the warps' (o, m, l) for the merge, over the ring
    const size_t merge = PW > 1 ? (size_t)warps * 16 * (D + 2) * 4 : 0;
    return q + (walk > merge ? walk : merge);
  }
};

__host__ __device__ inline int live_blocks(int start, int C, int bs,
                                           int nblocks) {
  const int live = (start + C + bs - 1) / bs;
  return live < 1 ? 1 : live > nblocks ? nblocks : live;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// (p0, p1) as three bf16 parts hi, mid, lo: each the rounded rest of the
// one before, so p - hi - mid - lo <= 2^-27 |p| (each subtraction exact)
__device__ __forceinline__ void split_bf16(float p0, float p1,
                                           uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    part[i] = pack_bf16(p0, p1);
    p0 -= bf16_lo(part[i]);
    p1 -= bf16_hi(part[i]);
  }
}

// Four bytes of 4-bit values (bytes 4j .. 4j + 3 of a copy) as the bf16
// pairs of their low nibbles lo[0..1] and of their high nibbles hi[0..1]:
// bytes 2pr and 2pr + 1 of the word, moved to bits 0-7 / 16-23.
__device__ __forceinline__ void int4_word(uint32_t w, uint32_t s2,
                                          uint32_t c2, uint32_t* lo,
                                          uint32_t* hi) {
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const uint32_t x = __byte_perm(w, 0u, pr ? 0x4342 : 0x4140);
    lo[pr] = int4_pair(x, 0, s2, c2);
    hi[pr] = int4_pair(x, 4, s2, c2);
  }
}

// CB raw pool bytes (copy ch of a position row) as bf16 values * sc into
// the row `dst`: 16 int8 values (elements 16 ch + i), or 2 CB int4 values
// (low nibbles elements CB ch + i, high nibbles D/2 + CB ch + i). 8-byte
// copies are 4-bit only (an 8-bit row of D % 16 == 0 bytes is whole
// 16-byte vectors).
template <int KIND, int D, int CB>
__device__ __forceinline__ void dequant(const unsigned char* src, int ch,
                                        float sc, __nv_bfloat16* dst) {
  if constexpr (KIND == kPoolQ8) {
    static_assert(CB == 16, "8-bit rows are whole 16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const float c = int8_bias(sc);
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = w[j] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = int8_val(x, i, sc, c);
      o[2 * j] = pack_bf16(f[0], f[1]);
      o[2 * j + 1] = pack_bf16(f[2], f[3]);
    }
    uint4* d4 = reinterpret_cast<uint4*>(dst + 16 * ch);
    d4[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d4[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {
    uint32_t s2, c2;
    int4_scale(sc, s2, c2);
    constexpr int W = CB / 4;                     // words a copy
    uint32_t w[W], lo[2 * W], hi[2 * W];
    if constexpr (CB == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      w[0] = raw.x, w[1] = raw.y;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) int4_word(w[j], s2, c2, lo + 2 * j, hi + 2 * j);
    uint4* dl = reinterpret_cast<uint4*>(dst + CB * ch);
    uint4* dh = reinterpret_cast<uint4*>(dst + D / 2 + CB * ch);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      dl[i] = make_uint4(lo[4 * i], lo[4 * i + 1], lo[4 * i + 2],
                         lo[4 * i + 3]);
      dh[i] = make_uint4(hi[4 * i], hi[4 * i + 1], hi[4 * i + 2],
                         hi[4 * i + 3]);
    }
  }
}

// element offset of (row of the C * g rows of kh, column d) in q / out
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int kh,
                                             int row, int d, int D) {
  const int G = a.h / a.kvh, c = row / G, gi = row % G;
  return (((size_t)b * a.C + c) * a.h + kh * G + gi) * D + d;
}

// One block: query rows [r0, r0 + 16 RW) of KV head kh in batch row b,
// over the positions of sequence part `part`. Warp w is row warp w / PW
// (16 rows) and position warp w % PW (positions [16 (w % PW), + TP / PW)
// of every tile).
template <int KIND, int D, int PW>
__global__ void __launch_bounds__(32 * kMaxWarps)
attend_kernel(Args a) {
  using L = Tiles<KIND, D, PW>;
  constexpr int TP = L::TP, TPW = L::TPW, S = L::S, CB = L::CB, CH = L::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rw = warp / PW, pw = warp % PW;
  const int g = lane >> 2, t = lane & 3;            // mma fragment coordinates
  const int part = blockIdx.x, kh = blockIdx.y % a.kvh;
  const int r0 = (blockIdx.y / a.kvh) * L::GROUP, b = blockIdx.z;
  const int G = a.h / a.kvh, R = a.C * G;
  const int qrows = 16 * (nthr / 32 / PW);          // 16 rows a row warp
  const int start = a.starts[b] - a.start_off;
  const int live = live_blocks(start, a.C, a.bs, a.nblocks);
  const int blk_lo = part * a.bpp;
  const int blk_hi = min(blk_lo + a.bpp, live);
  if (blk_lo >= blk_hi) return;                     // the combine skips it
  const int pos_lo = blk_lo * a.bs, pos_hi = blk_hi * a.bs;
  const int n_tiles = (pos_hi - pos_lo + TP - 1) / TP;

  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + (size_t)qrows * S * 2;
  __nv_bfloat16* Kb =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * 2 * L::kRaw);
  __nv_bfloat16* Vb = Kb + TP * S;
  const int32_t* trow = a.table + (size_t)b * a.table_stride;

  for (int i = tid; i < qrows * (D / 8); i += nthr) {
    const int rr = i / (D / 8), col = (i % (D / 8)) * 8, row = r0 + rr;
    const bool ok = row < R;
    cp_async16(Qs + rr * S + col,
               ok ? a.q + row_offset(a, b, kh, row, col, D) : a.q, ok);
  }
  cp_async_commit();

  // tile it: positions [pos_lo + it * TP, + TP) of K and V, past pos_hi
  // zero-filled (never read), every thread issuing copies
  auto issue = [&](int it) {
    if (it < n_tiles) {
      unsigned char* slot = ring + (it % kStages) * 2 * L::kRaw;
      const int p0 = pos_lo + it * TP;
      for (int i = tid; i < 2 * TP * CH; i += nthr) {
        const int kv = i / (TP * CH), tt = (i / CH) % TP, ch = i % CH;
        const int pos = p0 + tt;
        const bool ok = pos < pos_hi;
        const uint8_t* pool = kv ? a.v : a.k;
        const uint8_t* src = pool;
        if (ok) {
          const int blk = __ldg(trow + pos / a.bs);
          const size_t prow = ((size_t)blk * a.bs + pos % a.bs) * a.kvh + kh;
          src = pool + prow * L::ROW + CB * ch;
        }
        unsigned char* dst = slot + kv * L::kRaw + tt * L::RAW + CB * ch;
        if constexpr (CB == 16) cp_async16(dst, src, ok);
        else cp_async8(dst, src, ok);
      }
    }
    cp_async_commit();   // always: keeps the group count per tile fixed
  };

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};           // this thread's part of the row sums
  const int wrow = r0 + rw * 16 + g;
  int horizon[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;      // padding rows: anything finite
    horizon[r] = start + (row < R ? row / G : a.C - 1);
  }
  const __nv_bfloat16* Qw = Qs + rw * 16 * S;
  const int tw = pw * TPW;             // this warp's first position a tile
  const float kDead = __int_as_float(0xff800000u);   // -inf

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile it landed; tile it - 1 consumed everywhere
    issue(it + kStages - 1);
    const unsigned char* slot = ring + (it % kStages) * 2 * L::kRaw;
    const int p0 = pos_lo + it * TP;
    const __nv_bfloat16* Kt;
    const __nv_bfloat16* Vt;
    if constexpr (KIND == kPoolBF16) {
      Kt = reinterpret_cast<const __nv_bfloat16*>(slot);
      Vt = reinterpret_cast<const __nv_bfloat16*>(slot + L::kRaw);
    } else {
      for (int i = tid; i < 2 * TP * CH; i += nthr) {
        const int kv = i / (TP * CH), tt = (i / CH) % TP, ch = i % CH;
        const int pos = p0 + tt;
        float sc = 1.f;          // past pos_hi: zero bytes -> zeros
        if (pos < pos_hi) {
          const int blk = __ldg(trow + pos / a.bs);
          const int8_t* ex = kv ? a.v_exp : a.k_exp;
          sc = exp2i(__ldg(ex + (size_t)blk * a.kvh + kh));
        }
        dequant<KIND, D, CB>(slot + kv * L::kRaw + tt * L::RAW + CB * ch, ch,
                             sc, (kv ? Vb : Kb) + tt * S);
      }
      __syncthreads();
      Kt = Kb;
      Vt = Vb;
    }

    // S = Q K^T: 16 rows x TPW positions a warp
    float s[TPW / 8][4];
#pragma unroll
    for (int j = 0; j < TPW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qw + g * S + kk * 16 + 2 * t;
      const uint32_t qf[4] = {ld32(qa), ld32(qa + 8 * S), ld32(qa + 8),
                              ld32(qa + 8 * S + 8)};
#pragma unroll
      for (int j = 0; j < TPW / 8; ++j) {
        const __nv_bfloat16* kr = Kt + (tw + 8 * j + g) * S + kk * 16 + 2 * t;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, qf, ld32(kr), ld32(kr + 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] += part[i];
      }
    }

    // scale and mask; c0, c1 are row g, c2, c3 row g + 8, positions 2t, 2t+1
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < TPW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = p0 + tw + 8 * j + 2 * t + (i & 1);
        float x = s[j][i] * a.scale;
        if (pos >= pos_hi) x = kDead;
        else if (pos > horizon[i >> 1]) x = kNegInf;
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
    for (int j = 0; j < TPW / 8; ++j)
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

    // O += P V with P = hi + mid + lo: P's A fragments are S's
    // accumulators (positions 16kk .. 16kk + 15 are n-tiles 2kk and
    // 2kk + 1); V's B fragments by ldmatrix.trans, two n-tiles (16 columns
    // of d) a load
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < TPW / 16; ++kk) {
      uint32_t f[4][3], pa[3][4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], f[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], f[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], f[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], f[3]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[i][j] = f[j][i];
      const __nv_bfloat16* vr =
          Vt + (tw + 16 * kk + (mi & 1) * 8 + mr) * S + (mi >> 1) * 8;
#pragma unroll
      for (int mm = 0; mm < D / 16; ++mm) {
        uint32_t v[4];
        ldmatrix_x4_trans(v, vr + 16 * mm);
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(part[0], pa[i], v[0], v[1]);
          mma_bf16(part[1], pa[i], v[2], v[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          oacc[2 * mm][i] += part[0][i];
          oacc[2 * mm + 1][i] += part[1][i];
        }
      }
    }
  }
  cp_async_wait<0>();

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_r[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t slot0 = ((size_t)(b * a.kvh + kh) * a.parts + part) * R;
  if (PW == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 8 * r;
      if (row >= R) continue;
      float2* o = reinterpret_cast<float2*>(a.ws_o + (slot0 + row) * D);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        o[4 * n + t] = make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
      if (t == 0) a.ws_ml[slot0 + row] = make_float2(m_r[r], l[r]);
    }
    return;
  }
  // PW position warps: each warp's (o, m, l) to shared memory (over the
  // ring, now idle), then merged per row in warp order into the part's
  // workspace slot
  __syncthreads();
  const int nwarps = nthr / 32;
  float* mo = reinterpret_cast<float*>(ring);       // [warp][16][D]
  float2* mml = reinterpret_cast<float2*>(mo + nwarps * 16 * D);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = g + 8 * r;
    if (r0 + rw * 16 + lr >= R) continue;
    float2* o = reinterpret_cast<float2*>(mo + (warp * 16 + lr) * D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      o[4 * n + t] = make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
    if (t == 0) mml[warp * 16 + lr] = make_float2(m_r[r], l[r]);
  }
  __syncthreads();
  for (int i = tid; i < qrows * (D / 4); i += nthr) {
    const int qr = i / (D / 4), d = (i % (D / 4)) * 4;
    const int row = r0 + qr;
    if (row >= R) continue;
    const int w0 = (qr / 16) * PW, lr = qr % 16;
    float m = mml[w0 * 16 + lr].x;
#pragma unroll
    for (int w = 1; w < PW; ++w) m = fmaxf(m, mml[(w0 + w) * 16 + lr].x);
    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < PW; ++w) {
      const float2 ml = mml[(w0 + w) * 16 + lr];
      const float f = expf(ml.x - m);
      lsum += ml.y * f;
      const float4 v =
          *reinterpret_cast<const float4*>(mo + ((w0 + w) * 16 + lr) * D + d);
      o[0] += v.x * f;
      o[1] += v.y * f;
      o[2] += v.z * f;
      o[3] += v.w * f;
    }
    *reinterpret_cast<float4*>(a.ws_o + (slot0 + row) * D + d) =
        make_float4(o[0], o[1], o[2], o[3]);
    if (d == 0) a.ws_ml[slot0 + row] = make_float2(m, lsum);
  }
}

// Combines the live parts of each (row, 4 columns), in part order.
__global__ void __launch_bounds__(256)
combine_kernel(Args a, int D) {
  const int b = blockIdx.z, kh = blockIdx.y;
  const int R = a.C * (a.h / a.kvh);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * (D / 4)) return;
  const int row = idx / (D / 4), d = (idx % (D / 4)) * 4;
  const int live =
      live_blocks(a.starts[b] - a.start_off, a.C, a.bs, a.nblocks);
  const int nparts = min(a.parts, (live + a.bpp - 1) / a.bpp);
  const size_t base = (size_t)(b * a.kvh + kh) * a.parts * R + row;
  float m = a.ws_ml[base].x;
  for (int p = 1; p < nparts; ++p)
    m = fmaxf(m, a.ws_ml[base + (size_t)p * R].x);
  float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p = 0; p < nparts; ++p) {
    const size_t slot = base + (size_t)p * R;
    const float2 ml = a.ws_ml[slot];
    const float f = expf(ml.x - m);
    l += ml.y * f;
    const float4 v = *reinterpret_cast<const float4*>(a.ws_o + slot * D + d);
    o[0] += v.x * f;
    o[1] += v.y * f;
    o[2] += v.z * f;
    o[3] += v.w * f;
  }
  const float den = fmaxf(l, 1e-30f);
  const float v[4] = {o[0] / den, o[1] / den, o[2] / den, o[3] / den};
  store4(a.out, row_offset(a, b, kh, row, d, D), v, a.out_kind, a.epi.regs,
         a.epi);
}

template <int KIND, int D, int PW>
int launch(const Args& a, int batch, cudaStream_t st) {
  using L = Tiles<KIND, D, PW>;
  const int R = a.C * (a.h / a.kvh);
  const int groups = (R + L::GROUP - 1) / L::GROUP;
  const int row_warps = min(kMaxWarps / PW, (R + 15) / 16);
  const size_t smem = L::smem(16 * row_warps, row_warps * PW);
  auto kern = attend_kernel<KIND, D, PW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.parts, a.kvh * groups, batch), 32 * row_warps * PW, smem,
         st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = R * (D / 4);
  combine_kernel<<<dim3((n + 255) / 256, a.kvh, batch), 256, 0, st>>>(a, D);
  return (int)cudaGetLastError();
}

template <int KIND, int PW>
int dispatch_d(int d, const Args& a, int batch, cudaStream_t st) {
  switch (d) {
    case 16: return launch<KIND, 16, PW>(a, batch, st);
    case 32: return launch<KIND, 32, PW>(a, batch, st);
    case 48: return launch<KIND, 48, PW>(a, batch, st);
    case 64: return launch<KIND, 64, PW>(a, batch, st);
    case 128: return launch<KIND, 128, PW>(a, batch, st);
    case 192: return launch<KIND, 192, PW>(a, batch, st);
    case 256: return launch<KIND, 256, PW>(a, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int PW>
int dispatch_pool(int kv_bits, int d, const Args& a, int batch,
                  cudaStream_t st) {
  if (kv_bits == 16) return dispatch_d<kPoolBF16, PW>(d, a, batch, st);
  if (kv_bits == 8) return dispatch_d<kPoolQ8, PW>(d, a, batch, st);
  if (kv_bits == 4) return dispatch_d<kPoolQ4, PW>(d, a, batch, st);
  return (int)cudaErrorInvalidValue;
}

int run(bool decode, const void* q, const void* k_pool, const void* v_pool,
        const void* k_exp, const void* v_exp, int kv_bits, const void* table,
        int table_stride, const void* starts, void* out, void* ws_o,
        void* ws_ml, int batch, int chunk, int h, int kvh, int d, int bs,
        int nblocks, int parts, int bpp, float scale, int out_kind,
        const void* regs, int num_exponents, int qmin, int qmax, float inv_s,
        void* stream) {
  if (batch <= 0) return 0;
  const int group = decode ? 16 * (kMaxWarps / kDecodeWarps) : 16 * kMaxWarps;
  if (nblocks < 1 || kvh < 1 || h % kvh != 0 || bs < 1 || chunk < 1 ||
      parts < 1 || bpp < 1 || (long long)(parts - 1) * bpp >= nblocks ||
      (long long)parts * bpp < nblocks || batch > 65535 ||
      (long long)kvh * ((chunk * (h / kvh) + group - 1) / group) > 65535)
    return (int)cudaErrorInvalidValue;
  if (ws_o == nullptr || ws_ml == nullptr) return (int)cudaErrorInvalidValue;
  if (out_kind == kOutGrau && regs == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kv_bits != 16 && (k_exp == nullptr || v_exp == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q, (const uint8_t*)k_pool,
               (const uint8_t*)v_pool, (const int8_t*)k_exp,
               (const int8_t*)v_exp, (const int32_t*)table, table_stride,
               (const int32_t*)starts, decode ? 1 : 0, out, (float*)ws_o,
               (float2*)ws_ml, chunk, h, kvh, bs, nblocks, parts, bpp, scale,
               out_kind,
               Epilogue{(const int32_t*)regs, num_exponents, qmin, qmax,
                        inv_s}};
  const cudaStream_t st = (cudaStream_t)stream;
  return decode ? dispatch_pool<kDecodeWarps>(kv_bits, d, a, batch, st)
                : dispatch_pool<1>(kv_bits, d, a, batch, st);
}

}  // namespace

// q: (batch, chunk, h, d) bf16. kv_bits 16: bf16 pools (num_blocks, bs, kvh,
// d); 8 / 4: int8 pools of width d / d/2 with (num_blocks, kvh) int8
// exponent planes k_exp / v_exp. `parts` sequence parts of `bpp` table
// blocks each (the last may be shorter). out_kind: 0 = f32, 1 = bf16, 2 =
// GRAU byte (regs: the register file). ws_o holds batch * kvh * parts *
// chunk * (h / kvh) * d floats and ws_ml one float2 per d of those.
extern "C" int paged_prefill_bf16_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_exp,
    const void* v_exp, int kv_bits, const void* table, int table_stride,
    const void* starts, void* out, void* ws_o, void* ws_ml, int batch,
    int chunk, int h, int kvh, int d, int bs, int nblocks, int parts, int bpp,
    float scale, int out_kind, const void* regs, int num_exponents, int qmin,
    int qmax, float inv_s, void* stream) {
  return run(false, q, k_pool, v_pool, k_exp, v_exp, kv_bits, table,
             table_stride, starts, out, ws_o, ws_ml, batch, chunk, h, kvh, d,
             bs, nblocks, parts, bpp, scale, out_kind, regs, num_exponents,
             qmin, qmax, inv_s, stream);
}

// Decode: q (slots, h, d) bf16, `lengths` (slots,) int32 (slot b attends
// positions [0, lengths[b])); otherwise as paged_prefill_bf16_launch at
// chunk 1, the workspace holding slots * kvh * parts * (h / kvh) * d floats.
extern "C" int paged_decode_bf16_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_exp,
    const void* v_exp, int kv_bits, const void* table, int table_stride,
    const void* lengths, void* out, void* ws_o, void* ws_ml, int slots,
    int h, int kvh, int d, int bs, int nblocks, int parts, int bpp,
    float scale, int out_kind, const void* regs, int num_exponents, int qmin,
    int qmax, float inv_s, void* stream) {
  return run(true, q, k_pool, v_pool, k_exp, v_exp, kv_bits, table,
             table_stride, lengths, out, ws_o, ws_ml, slots, 1, h, kvh, d, bs,
             nblocks, parts, bpp, scale, out_kind, regs, num_exponents, qmin,
             qmax, inv_s, stream);
}
