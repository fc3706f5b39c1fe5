// Extend-add placement of child update blocks (K7) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/extend_add.py
// (extend_add, body _kernel, pallas_call at :110). For parent fronts
// F (B, R, R), child blocks (np, RU, RU), row maps idx (np, RU) (-1 = no
// row) and destination slots dst (np,) sorted ascending:
//
//   F[dst[p], idx[p, i], idx[p, j]] += child[p, i, j]   where both idx >= 0
//
// F is updated in place (the TPU kernel returned F + the contribution).
//
// What bounds it on the H100: bytes. Each valid child cell is read once and
// added into one parent cell, one flop per 4-12 bytes. The TPU kernel placed
// rows, transposed and placed rows again through VMEM scratch, one grid
// step per pair; here one block owns one destination slot and walks that
// slot's run of pairs in order (the run is found by binary search in the
// sorted dst, so no host pass is needed). For each pair the block stages the
// row map in shared memory and its threads take consecutive child cells
// (coalesced reads), each adding its cell straight into F; consecutive
// child columns land on increasing parent columns, since the maps are
// sorted. One pair's destinations are distinct and a slot belongs to one
// block, so no atomics are needed: a barrier between pairs orders the adds
// of two pairs that hit the same cell.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ inline int lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
extend_add_kernel(float* __restrict__ F, const float* __restrict__ child,
                  const int* __restrict__ idx, const int* __restrict__ dst,
                  int np, int R, int RU) {
  extern __shared__ int map[];  // RU: the pair's row map
  const int slot = blockIdx.x;
  const int t = threadIdx.x;
  const int p0 = lower_bound(dst, np, slot);
  const int p1 = lower_bound(dst, np, slot + 1);
  float* Fs = F + (size_t)slot * R * R;
  const int cells = RU * RU;
  for (int p = p0; p < p1; ++p) {
    __syncthreads();  // the previous pair's adds and map reads are done
    for (int i = t; i < RU; i += kThreads) map[i] = idx[(size_t)p * RU + i];
    __syncthreads();
    const float* Cp = child + (size_t)p * cells;
    for (int e = t; e < cells; e += kThreads) {
      const int i = e / RU;
      const int r = map[i];
      const int c = map[e - i * RU];
      if (r >= 0 && c >= 0) Fs[(size_t)r * R + c] += Cp[e];
    }
  }
}

}  // namespace

extern "C" int sst_extend_add(void* F, const void* child, const void* idx,
                              const void* dst, int np, int B, int R, int RU,
                              void* stream) {
  if (np < 0 || B < 0 || R < 1 || RU < 0) return (int)cudaErrorInvalidValue;
  if (np == 0 || B == 0 || RU == 0) return 0;
  const size_t smem = sizeof(int) * RU;
  cudaError_t err = cudaFuncSetAttribute(
      extend_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  extend_add_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)F, (const float*)child, (const int*)idx, (const int*)dst, np, R,
      RU);
  return (int)cudaGetLastError();
}
