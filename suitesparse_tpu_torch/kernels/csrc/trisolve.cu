// Batched small triangular solve (K4) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/trisolve.py
// (batched_trisolve, body _kernel, pallas_call at :89). For B lower-
// triangular fp32 tiles L (B, C, C) with a nonzero diagonal (identity on
// padding) and right-hand sides Y (B, C, NR) it writes X = L^-1 Y, or
// X = L^-T Y when `transpose` is set.
//
// What bounds it on the H100: latency. A tile moves (C*C + 2*C*NR) * 4
// bytes (37 KB at C = 96, NR = 1) for C*C*NR multiply-adds, and its C column
// steps depend on each other. The design runs one block per tile, with the
// tile and its right-hand sides in shared memory (L at an odd row stride,
// 37 KB + 24 KB at C = 96, NR = 64): each step is a burst of shared-memory
// work between two barriers (tile_trisolve.cuh), and the chains of the B
// tiles of a group overlap across the 132 SMs. The TPU kernel's lane-major
// transpose, batch padding and VMEM budget are not carried over; a tile
// whose shared memory would exceed 227 KB is refused (trisolve_fits).

#include <cuda_runtime.h>

#include "tile_trisolve.cuh"

namespace {

constexpr int kMaxC = 96;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

size_t trisolve_smem(int C, int NR) {
  return sizeof(float) * ((size_t)C * sst::odd_stride(C) + (size_t)C * NR);
}

template <bool kTranspose>
__global__ void trisolve_kernel(const float* __restrict__ L,
                                const float* __restrict__ Y,
                                float* __restrict__ X, int C, int NR) {
  extern __shared__ float smem[];
  const int ld = sst::odd_stride(C);
  float* Ls = smem;           // C x ld: the tile
  float* Xs = Ls + C * ld;    // C x NR: the right-hand sides, then X
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;

  const float* Lb = L + b * C * C;
  const float* Yb = Y + b * C * NR;
  for (int e = t; e < C * C; e += nt) Ls[(e / C) * ld + e % C] = Lb[e];
  for (int e = t; e < C * NR; e += nt) Xs[e] = Yb[e];
  __syncthreads();

  sst::tile_trisolve<kTranspose>(Ls, ld, Xs, C, NR);

  float* Xb = X + b * C * NR;
  for (int e = t; e < C * NR; e += nt) Xb[e] = Xs[e];
}

}  // namespace

extern "C" int sst_trisolve(const void* L, const void* Y, void* X, int B,
                            int C, int NR, int transpose, void* stream) {
  if (B < 0 || C < 1 || C > kMaxC || NR < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = trisolve_smem(C, NR);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int threads = sst::block_threads((long)C * NR);
  cudaError_t err;
  if (transpose) {
    err = cudaFuncSetAttribute(trisolve_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    trisolve_kernel<true><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)L, (const float*)Y, (float*)X, C, NR);
  } else {
    err = cudaFuncSetAttribute(trisolve_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    trisolve_kernel<false><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)L, (const float*)Y, (float*)X, C, NR);
  }
  return (int)cudaGetLastError();
}
