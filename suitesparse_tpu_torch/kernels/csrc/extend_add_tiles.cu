// Tiled multifrontal extend-add for Hopper (sm_90a).
//
// Replaces the one-piece Pallas kernel suitesparse_tpu/kernels/
// extend_add_tiles.py (extend_add_tiles, body _kernel, pallas_call at :381).
// A manifest (built on the host by build_group_manifest) lists, for every
// lower 128 x 128 tile of the parent fronts F that receives child updates,
// one step per contributing child ("piece"); the steps of one tile are
// consecutive, and run_ptr holds the first step of each tile's run. A piece
// adds P_r U P_c^T into the tile: tile row i takes child row
//   (rm[i] < 128 ? blkr : blkr2) * 128 + rm[i] % 128
// of the child's update block in Ucat (columns likewise from colmap and
// blkc/blkc2); -1 in a map means no entry. A non-finite child cell counts as
// zero (upper cells of a lower-only-assembled child hold no valid data).
// Tiles without pieces are never visited and keep their content.
//
// What bounds it on the H100: memory bandwidth. A piece moves up to 64 KB of
// child cells for 16 K additions, and the tile itself is 64 KB. The design
// gives each visited tile one block of 128 x 4 threads; a thread owns one
// column and 32 rows of the tile and sums every piece of the run in
// registers, so each child cell is read once and each tile of F is read and
// written once, with neighbouring threads on neighbouring addresses. Runs
// own disjoint tiles: F is updated in place without atomics. The TPU
// kernel's one-hot placement dots and its SMEM chunking are not needed: a
// thread loads the child cell its maps name directly.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kRowPhases = 4;
constexpr int kRowsPerThread = kTile / kRowPhases;
constexpr int kManCols = 10;  // slot tr tc init has_piece uslot blkr blkr2 blkc blkc2

__device__ inline int child_index(int v, int blk, int blk2) {
  return v < 0 ? -1 : (v < kTile ? blk : blk2) * kTile + (v & (kTile - 1));
}

__global__ void __launch_bounds__(kTile * kRowPhases)
extend_add_tiles_kernel(float* __restrict__ F, const float* __restrict__ U,
                        const int* __restrict__ man,
                        const int* __restrict__ rowmap,
                        const int* __restrict__ colmap,
                        const int* __restrict__ run_ptr, int R, int RUp) {
  __shared__ int crow[kTile];  // child row of each tile row (-1: none)
  __shared__ int ccol[kTile];  // child column of each tile column
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int s0 = run_ptr[blockIdx.x];
  const int s1 = run_ptr[blockIdx.x + 1];
  const int slot = man[(size_t)s0 * kManCols + 0];
  const int tr = man[(size_t)s0 * kManCols + 1];
  const int tc = man[(size_t)s0 * kManCols + 2];

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.0f;

  for (int s = s0; s < s1; ++s) {
    const int* m = man + (size_t)s * kManCols;
    __syncthreads();  // the previous piece's maps are no longer read
    if (tid < kTile)
      crow[tid] = child_index(rowmap[(size_t)s * kTile + tid], m[6], m[7]);
    else if (tid < 2 * kTile)
      ccol[tid - kTile] =
          child_index(colmap[(size_t)s * kTile + tid - kTile], m[8], m[9]);
    __syncthreads();
    const int cc = ccol[tx];
    if (m[4] == 0 || cc < 0) continue;
    const float* Uc = U + (size_t)m[5] * RUp * RUp + cc;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int rr = crow[ty + q * kRowPhases];
      if (rr >= 0) {
        const float v = Uc[(size_t)rr * RUp];
        acc[q] += isfinite(v) ? v : 0.0f;
      }
    }
  }

  const int c = tc * kTile + tx;
  if (c >= R) return;
  float* Fc = F + (size_t)slot * R * R + c;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = tr * kTile + ty + q * kRowPhases;
    if (r < R) Fc[(size_t)r * R] += acc[q];
  }
}

}  // namespace

extern "C" int sst_extend_add_tiles(void* F, const void* Ucat, const void* man,
                                    const void* rowmap, const void* colmap,
                                    const void* run_ptr, int nruns, int R,
                                    int RUp, void* stream) {
  if (nruns < 0 || R < 1 || RUp < kTile || RUp % kTile != 0)
    return (int)cudaErrorInvalidValue;
  if (nruns == 0) return 0;
  extend_add_tiles_kernel<<<nruns, dim3(kTile, kRowPhases), 0,
                            (cudaStream_t)stream>>>(
      (float*)F, (const float*)Ucat, (const int*)man, (const int*)rowmap,
      (const int*)colmap, (const int*)run_ptr, R, RUp);
  return (int)cudaGetLastError();
}
