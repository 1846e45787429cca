// The pieces that csrc/matmul_wq.cu and csrc/paged_prefill.cu share: the
// cp.async ring, mma.sync m16n8k16 on bf16 with f32 accumulators, and the
// exact in-register conversion of power-of-two-scaled int8 / int4 values to
// bf16 (q * 2^e needs 8 significand bits and an exponent >= -126, which bf16
// has), plus the output kinds and the GRAU epilogue's arguments.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "grau_datapath.cuh"

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutGrau = 2 };

struct Epilogue {
  const int32_t* regs;   // GRAU register file (global), or null
  int num_exponents, qmin, qmax;
  float inv_s;
};

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
// 8 bytes global -> shared (both 8-byte aligned); zero-filled when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^e built by bits (exact; e >= -126)
__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive outputs of one row to `out` at element offset `off`
// (16-byte aligned for f32): f32, bf16, or the GRAU bus byte of
// __float2int_rn(v * inv_s) (round half even, saturating) through the
// datapath with register file `regs` (shared or global memory).
__device__ __forceinline__ void store4(void* out, size_t off,
                                      const float (&v)[4], int out_kind,
                                      const int32_t* regs,
                                      const Epilogue& epi) {
  if (out_kind == kOutF32) {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + off) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else if (out_kind == kOutBF16) {
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + off) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int32_t xq = __float2int_rn(v[i] * epi.inv_s);
      const uint32_t y = (uint8_t)grau_datapath(xq, regs, epi.num_exponents,
                                                epi.qmin, epi.qmax);
      word |= y << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(out) + off) = word;
  }
}

// int4: the scale pair of one exponent for int4_pair
__device__ __forceinline__ void int4_scale(float sc, uint32_t& s2,
                                           uint32_t& c2) {
  s2 = pack_bf16(sc, sc);
  c2 = pack_bf16(-136.f * sc, -136.f * sc);
}
// Two bf16 values from the signed 4-bit fields at bits [sh, sh + 4) and
// [sh + 16, sh + 20) of w: (w & 0x000F000F) ^ 0x43084308 is the pair
// 128 + (n ^ 8), and one fma by (2^e, -136 * 2^e) leaves q * 2^e.
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, int sh, uint32_t s2,
                                              uint32_t c2) {
  return fma_bf16x2(((w >> sh) & 0x000F000Fu) ^ 0x43084308u, s2, c2);
}
// int8: q * sc for byte i of w, w already XORed with 0x80808080: the f32
// 2^23 + (q + 128) by a prmt, then one fma with (sc, c), c = int8_bias(sc).
__device__ __forceinline__ float int8_bias(float sc) {
  return -8388736.f * sc;
}
__device__ __forceinline__ float int8_val(uint32_t w, int i, float sc,
                                          float c) {
  return fmaf(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)), sc, c);
}
