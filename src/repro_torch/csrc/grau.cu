// Standalone GRAU unit for Hopper (sm_90a).
//
// Replaces: the JAX package's kernels/grau.py::grau_pallas (body
// _grau_kernel, datapath grau_datapath).
//
// Computes, per element of an (M, N) int32 array: the comparator bank, the
// setting-buffer select, the unrolled shift-add pipeline and the clamp
// (grau_datapath.cuh), writing one byte (int8 or uint8: the clamped value
// fits either, so the byte is the same) per element.
//
// Bound on the H100: memory bytes. 4 bytes in + 1 byte out per element for
// at most ~40 integer operations; the card needs ~20 operations per byte
// before its integer ALUs, not HBM, are the limit. Design: a grid-stride
// loop with each thread handling four neighbouring elements through one
// 16-byte load and one 4-byte store when the row allows it, so warps issue
// full 128-byte transactions; the 32-word register file is staged once per
// block in shared memory (runtime data: a new spec never needs a rebuild).
#include <cuda_runtime.h>
#include <stdint.h>

#include "grau_datapath.cuh"

__global__ void grau_kernel(const int32_t* __restrict__ x,
                            uint8_t* __restrict__ out, int64_t n,
                            const int32_t* __restrict__ regs_g,
                            int num_exponents, int qmin, int qmax) {
  __shared__ int32_t regs[GRAU_REG_WORDS];
  if (threadIdx.x < GRAU_REG_WORDS) regs[threadIdx.x] = regs_g[threadIdx.x];
  __syncthreads();
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const int4 v = reinterpret_cast<const int4*>(x)[i];
    uchar4 o;
    o.x = (uint8_t)grau_datapath(v.x, regs, num_exponents, qmin, qmax);
    o.y = (uint8_t)grau_datapath(v.y, regs, num_exponents, qmin, qmax);
    o.z = (uint8_t)grau_datapath(v.z, regs, num_exponents, qmin, qmax);
    o.w = (uint8_t)grau_datapath(v.w, regs, num_exponents, qmin, qmax);
    reinterpret_cast<uchar4*>(out)[i] = o;
  }
  // ragged tail (n not a multiple of 4)
  for (int64_t i = nvec * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = (uint8_t)grau_datapath(x[i], regs, num_exponents, qmin, qmax);
  }
}

extern "C" int grau_launch(const void* x, void* out, long long n,
                           const void* regs, int num_exponents, int qmin,
                           int qmax, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
  grau_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (uint8_t*)out, (int64_t)n, (const int32_t*)regs,
      num_exponents, qmin, qmax);
  return (int)cudaGetLastError();
}
