// The GRAU integer datapath as one device function, shared by the
// standalone unit (grau.cu) and the fused epilogue of both paged-attention
// kernels (paged_attention.cu) — the counterpart of grau_datapath in the
// JAX package's kernels/grau.py, so the executable RTL spec exists once.
//
// Register file: REG_WORDS int32 words (pwlf/spec.py packs them):
//   [0, 7)   breakpoints (padded with INT32_MAX)
//   [7, 15)  enc rows, bit-packed (bit k => stage k fires)
//   [15, 23) sign
//   [23, 31) bias
//   [31]     pre-shift (may be negative)
//
// int32 semantics pinned to the reference (C++ leaves these undefined):
//   * right shift by >= 32 fills with the sign bit (count clamped to 31);
//   * left shift by >= 32 gives 0, and a left shift is done on uint32_t;
//   * the accumulator and sign * acc + bias wrap modulo 2^32 (uint32_t).
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

// regs may point to shared or global memory.
__device__ __forceinline__ int32_t grau_datapath(int32_t x, const int32_t* regs,
                                                 int num_exponents, int qmin,
                                                 int qmax) {
  int seg = 0;
#pragma unroll
  for (int i = 0; i < GRAU_MAX_SEGMENTS - 1; ++i) seg += (x > regs[GRAU_REG_BP + i]);
  const int32_t bits = regs[GRAU_REG_ENC + seg];
  const int32_t pre = regs[GRAU_REG_PRE];
  uint32_t acc = 0u;
  for (int k = 0; k < num_exponents; ++k) {
    if ((bits >> k) & 1) acc += (uint32_t)grau_shift_term(x, pre + k);
  }
  const uint32_t y = (uint32_t)regs[GRAU_REG_SIGN + seg] * acc +
                     (uint32_t)regs[GRAU_REG_BIAS + seg];
  int32_t yi = (int32_t)y;
  yi = yi < qmin ? qmin : yi;
  return yi > qmax ? qmax : yi;
}
