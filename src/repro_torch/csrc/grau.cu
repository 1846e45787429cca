// Standalone GRAU unit for Hopper (sm_90a).
//
// Replaces: the JAX package's kernels/grau.py::grau_pallas (body
// _grau_kernel, datapath grau_datapath).
//
// Computes, per element of an (M, N) int32 array: the comparator bank, the
// setting-buffer select, the shift-add pipeline over the stages that fire
// and the clamp (grau_datapath.cuh), writing one byte (int8 or uint8: the
// clamped value fits either, so the byte is the same) per element.
//
// Bound on the H100: 4 bytes in and 1 out an element (1.49 ns a thousand
// elements at 3.35 TB/s) against ~21 integer operations an element plus 4
// a fired stage (1.3 ns a thousand at one operation a lane a cycle on
// 132 SMs x 64 INT32 lanes): the two are close, so neither memory nor the
// ALUs may idle. Design: a grid sized to the SMs (at most 8 blocks of 256
// threads each) walks the array in warp tiles; on an array large enough
// to give every thread of that grid 8 elements, a lane loads two 16-byte
// vectors 512 bytes apart (each warp load 512 contiguous bytes) and
// evaluates its 8 elements, else one vector (4 elements: a smaller array
// is latency-bound, and more threads take it). The unit's invariant words
// (breakpoints, pre-shift, stage mask) sit in registers and its segment
// rows in a shared-memory table read with one 16-byte load an element
// (grau_datapath.cuh); each lane stores 4-byte words (128 contiguous bytes
// a warp store). Elements past the last whole 4-vector take a scalar loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grau_datapath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// kPair: a lane takes two 16-byte vectors of a 64-vector warp tile (8
// elements, two loads in flight), else one of a 32-vector tile (4 elements:
// for arrays too small to give every thread of a full grid 8, where the
// latency of a thread's chain sets the time).
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
grau_kernel(const int32_t* __restrict__ x, uint8_t* __restrict__ out,
            int64_t n, const int32_t* __restrict__ regs_g, int num_exponents,
            int qmin, int qmax) {
  __shared__ int4 table[GRAU_MAX_SEGMENTS];
  const GrauUnit u = grau_unit_load(regs_g, num_exponents, qmin, qmax);
  grau_table_fill(table, u, threadIdx.x);
  __syncthreads();
  constexpr int kTile = kPair ? 64 : 32;
  const int lane = threadIdx.x & 31;
  const int64_t n4 = n >> 2;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * kThreads) >> 5;
  const int4* xv = reinterpret_cast<const int4*>(x);
  uint32_t* ov = reinterpret_cast<uint32_t*>(out);
  for (int64_t base = warp * kTile; base < n4; base += warps * kTile) {
    const int64_t v0 = base + lane, v1 = v0 + 32;
    const bool h0 = v0 < n4, h1 = kPair && v1 < n4;
    const int4 a = h0 ? __ldg(xv + v0) : make_int4(0, 0, 0, 0);
    const int4 b = h1 ? __ldg(xv + v1) : make_int4(0, 0, 0, 0);
    if (h0) ov[v0] = grau_eval4(u, table, a);
    if (h1) ov[v1] = grau_eval4(u, table, b);
  }
  // ragged tail (n not a multiple of 4)
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = n4 * 4 + tid; i < n; i += (int64_t)gridDim.x * kThreads)
    out[i] = (uint8_t)grau_eval(u, x[i]);
}

}  // namespace

// x and out must start on a 16-byte and a 4-byte boundary (the wrapper
// copies a misaligned view); `sms` sizes the grid.
extern "C" int grau_launch(const void* x, void* out, long long n,
                           const void* regs, int num_exponents, int qmin,
                           int qmax, int sms, void* stream) {
  if (n <= 0) return 0;
  if (sms < 1 || (uintptr_t)x % 16 || (uintptr_t)out % 4)
    return (int)cudaErrorInvalidValue;
  const long long full = (long long)sms * kBlocksPerSm * kThreads;
  const bool pair = n / 8 >= full;      // 8 elements for every thread
  const long long tile = pair ? 64 : 32;
  const long long tiles = (n / 4 + tile - 1) / tile;          // warp tiles
  long long blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks < 1) blocks = 1;
  if (blocks > (long long)sms * kBlocksPerSm)
    blocks = (long long)sms * kBlocksPerSm;
  const dim3 grid((unsigned)blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pair)
    grau_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int32_t*)x, (uint8_t*)out, (int64_t)n, (const int32_t*)regs,
        num_exponents, qmin, qmax);
  else
    grau_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)x, (uint8_t*)out, (int64_t)n, (const int32_t*)regs,
        num_exponents, qmin, qmax);
  return (int)cudaGetLastError();
}
