// The GRAU integer datapath as one device function, shared by the
// standalone unit (grau.cu), the int8 GEMM's epilogue (matmul_grau.cu) and
// the fused epilogues of the attention and weight-quantized kernels
// (paged_attention.cu, and through bf16_mma.cuh paged_prefill.cu and
// matmul_wq.cu) — the counterpart of grau_datapath in the JAX package's
// kernels/grau.py, so the executable RTL spec exists once.
//
// Register file: REG_WORDS int32 words (pwlf/spec.py packs them):
//   [0, 7)   breakpoints (padded with INT32_MAX)
//   [7, 15)  enc rows, bit-packed (bit k => stage k fires)
//   [15, 23) sign
//   [23, 31) bias
//   [31]     pre-shift (may be negative)
// The register file is runtime data: a new spec never needs a rebuild.
//
// int32 semantics pinned to the reference (C++ leaves these undefined):
//   * right shift by >= 32 fills with the sign bit (count clamped to 31);
//   * left shift by >= 32 gives 0, and a left shift is done on uint32_t;
//   * the accumulator and sign * acc + bias wrap modulo 2^32 (uint32_t).
//
// Only the stages that fire are visited: enc[seg] masked to its low
// num_exponents bits, lowest set bit first (__ffs, then bits &= bits - 1);
// grau_eval4 takes the union of those bits over the warp.
// The reference's unrolled pipeline adds the same terms (a stage that does
// not fire adds 0, and the sum modulo 2^32 does not depend on the order).
// The fitted APoT units fire 0-4 of their 8 stages a segment (the
// quickstart's SiLU: 0, 2, 2, 4, 3, 0), so the loop runs that often instead
// of testing every stage. With a pre-shift >= 0 (a uniform branch) every
// stage shifts right, and stage k's term is (x >> pre) >> k: one shift a
// fired stage.
#pragma once
#include <stdint.h>

#define GRAU_REG_WORDS 32
#define GRAU_REG_BP 0
#define GRAU_REG_ENC 7
#define GRAU_REG_SIGN 15
#define GRAU_REG_BIAS 23
#define GRAU_REG_PRE 31
#define GRAU_MAX_SEGMENTS 8

__device__ __forceinline__ int32_t grau_shift_term(int32_t x, int s) {
  if (s >= 0) return x >> (s < 31 ? s : 31);   // arithmetic: sign fill
  int l = -s;
  if (l >= 32) return 0;
  return (int32_t)((uint32_t)x << l);
}

// The loop-invariant part of a unit, loaded once per thread: breakpoints,
// pre-shift, stage mask and clamp bounds in registers; the per-segment rows
// (enc, sign, bias) are selected per element, from `regs` or from a table.
struct GrauUnit {
  int32_t bp[GRAU_MAX_SEGMENTS - 1];
  int32_t pre;
  uint32_t mask;
  int32_t qmin, qmax;
  const int32_t* regs;
};

// regs may point to shared or global memory.
__device__ __forceinline__ GrauUnit grau_unit_load(const int32_t* regs,
                                                   int num_exponents,
                                                   int qmin, int qmax) {
  GrauUnit u;
#pragma unroll
  for (int i = 0; i < GRAU_MAX_SEGMENTS - 1; ++i)
    u.bp[i] = regs[GRAU_REG_BP + i];
  u.pre = regs[GRAU_REG_PRE];
  u.mask = num_exponents >= 32 ? 0xffffffffu
           : num_exponents <= 0 ? 0u
                                : (1u << num_exponents) - 1u;
  u.qmin = qmin;
  u.qmax = qmax;
  u.regs = regs;
  return u;
}

// A segment's row: the stages that fire (enc masked to num_exponents bits),
// sign and bias.
struct GrauRow {
  uint32_t bits;
  int32_t sign, bias;
};

// The row from the packed register file: three loads.
__device__ __forceinline__ GrauRow grau_row(const GrauUnit& u, int seg) {
  return {(uint32_t)u.regs[GRAU_REG_ENC + seg] & u.mask,
          u.regs[GRAU_REG_SIGN + seg], u.regs[GRAU_REG_BIAS + seg]};
}

// The row from a table of GRAU_MAX_SEGMENTS int4 {enc & mask, sign, bias,
// 0} (in shared memory, filled by grau_table_fill): one 16-byte load.
__device__ __forceinline__ GrauRow grau_row(const int4* table, int seg) {
  const int4 r = table[seg];
  return {(uint32_t)r.x, r.y, r.z};
}

// Thread i < GRAU_MAX_SEGMENTS writes row i of the table (a barrier must
// follow before the table is read).
__device__ __forceinline__ void grau_table_fill(int4* table, const GrauUnit& u,
                                                int i) {
  if (i < GRAU_MAX_SEGMENTS) {
    const GrauRow r = grau_row(u, i);
    table[i] = make_int4((int32_t)r.bits, r.sign, r.bias, 0);
  }
}

__device__ __forceinline__ int32_t grau_finish(const GrauUnit& u,
                                               const GrauRow& r,
                                               uint32_t acc) {
  const uint32_t y = (uint32_t)r.sign * acc + (uint32_t)r.bias;
  int32_t yi = (int32_t)y;
  yi = yi < u.qmin ? u.qmin : yi;
  return yi > u.qmax ? u.qmax : yi;
}

__device__ __forceinline__ int grau_segment(const GrauUnit& u, int32_t x) {
  int seg = 0;
#pragma unroll
  for (int i = 0; i < GRAU_MAX_SEGMENTS - 1; ++i) seg += (x > u.bp[i]);
  return seg;
}

__device__ __forceinline__ int32_t grau_eval(const GrauUnit& u, int32_t x) {
  const GrauRow r = grau_row(u, grau_segment(u, x));
  uint32_t bits = r.bits;
  uint32_t acc = 0u;
  if (u.pre >= 0) {
    // right shifts only: x >> min(pre + k, 31) == (x >> min(pre, 31)) >> k
    // (arithmetic shifts compose; both sign-fill once the total reaches 31)
    const int32_t y = x >> (u.pre < 31 ? u.pre : 31);
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1u;
      acc += (uint32_t)(y >> k);
    }
  } else {
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1u;
      acc += (uint32_t)grau_shift_term(x, u.pre + k);
    }
  }
  return grau_finish(u, r, acc);
}

// Four elements as the 4 bytes of the bus (element 0 in the low byte), the
// rows from a grau_table_fill table. The loop
// runs over the stages that fire for any element of the warp's active
// lanes (an OR across the warp): the stage, and so the shift count, is the
// same in every lane, nothing diverges, and each element adds its term
// under a predicate. A per-element loop would run, in SIMT, as often as
// the warp's busiest element needs, each pass dearer.
// Must be called by whole warps or under __activemask() (it is).
__device__ __forceinline__ uint32_t grau_eval4(const GrauUnit& u,
                                               const int4* table, int4 v) {
  const int32_t x[4] = {v.x, v.y, v.z, v.w};
  GrauRow r[4];
  uint32_t bits[4], acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r[e] = grau_row(table, grau_segment(u, x[e]));
    bits[e] = r[e].bits;
    acc[e] = 0u;
  }
  // the stages that fire for any element of the warp's active lanes: one
  // uniform loop over them, each element adding its term under a predicate
  uint32_t todo = __reduce_or_sync(__activemask(),
                                   bits[0] | bits[1] | bits[2] | bits[3]);
  if (u.pre >= 0) {
    int32_t y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = x[e] >> (u.pre < 31 ? u.pre : 31);
    while (todo) {
      const int k = __ffs(todo) - 1;
      const uint32_t m = 1u << k;
      todo &= todo - 1u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (bits[e] & m) acc[e] += (uint32_t)(y[e] >> k);
    }
  } else {
    while (todo) {
      const int k = __ffs(todo) - 1;
      const uint32_t m = 1u << k;
      todo &= todo - 1u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (bits[e] & m) acc[e] += (uint32_t)grau_shift_term(x[e], u.pre + k);
    }
  }
  uint32_t word = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    word |= (uint32_t)(uint8_t)grau_finish(u, r[e], acc[e]) << (8 * e);
  return word;
}

// One element, the register file read where it lies (the fused epilogues'
// entry point; a loop over many elements loads the unit once instead).
__device__ __forceinline__ int32_t grau_datapath(int32_t x, const int32_t* regs,
                                                 int num_exponents, int qmin,
                                                 int qmax) {
  return grau_eval(grau_unit_load(regs, num_exponents, qmin, qmax), x);
}
