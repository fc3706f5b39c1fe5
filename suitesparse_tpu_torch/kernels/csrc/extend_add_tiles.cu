// Tiled multifrontal extend-add for Hopper (sm_90a), one or two pieces per
// manifest step.
//
// Replaces the Pallas kernels suitesparse_tpu/kernels/extend_add_tiles.py
// (extend_add_tiles; one-piece body _kernel, pallas_call at :381, and
// two-piece body _kernel2, pallas_call at :359). A manifest (built on the
// host by build_group_manifest) lists, for every lower 128 x 128 tile of the
// parent fronts F that receives child updates, the steps that add child
// updates ("pieces") into it; the steps of one tile are consecutive, and
// run_ptr holds the first step of each tile's run. A piece adds P_r U P_c^T
// into the tile: tile row i takes child row
//   (rm[i] < 128 ? blkr : blkr2) * 128 + rm[i] % 128
// of the child's update block in Ucat (columns likewise from colmap and
// blkc/blkc2); -1 in a map means no entry. A non-finite child cell counts as
// zero (upper cells of a lower-only-assembled child hold no valid data).
// Tiles without pieces are never visited and keep their content.
//
// Two manifest forms (NP pieces per step):
//   NP = 1, 10 columns: slot tr tc init has_piece uslot blkr blkr2 blkc blkc2
//   NP = 2, 14 columns: slot tr tc init, then uslot blkr blkr2 blkc blkc2 of
//           piece 0 and of piece 1; a dead second piece has all-(-1) maps.
// The maps are (NS, NP, 128).
//
// What bounds it on the H100: memory bandwidth. A piece moves up to 64 KB of
// child cells for 16 K additions, and the tile itself is 64 KB. The design
// gives each visited tile one block of 128 x 4 threads; a thread owns one
// column and 32 rows of the tile and sums every piece of the run in
// registers, so each child cell is read once and each tile of F is read and
// written once, with neighbouring threads on neighbouring addresses. Runs
// own disjoint tiles: F is updated in place without atomics. The TPU
// kernels' one-hot placement dots (6 a piece, 12 a two-piece step) and
// their SMEM chunking are not needed: a thread loads the child cell its maps
// name directly. The TPU paired pieces to halve its step-bound grid; here a
// block already walks its tile's whole run, so the two-piece form only
// halves the barriers between pieces (both pieces' maps are staged at once)
// and adds the pieces in the same order as the one-piece form.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kRowPhases = 4;
constexpr int kRowsPerThread = kTile / kRowPhases;

__device__ inline int child_index(int v, int blk, int blk2) {
  return v < 0 ? -1 : (v < kTile ? blk : blk2) * kTile + (v & (kTile - 1));
}

// manifest columns of piece p: uslot, then blkr blkr2 blkc blkc2
template <int NP>
__device__ inline int piece_col(int p) {
  return NP == 1 ? 5 : 4 + 5 * p;
}

template <int NP>
__global__ void __launch_bounds__(kTile * kRowPhases)
extend_add_tiles_kernel(float* __restrict__ F, const float* __restrict__ U,
                        const int* __restrict__ man,
                        const int* __restrict__ rowmap,
                        const int* __restrict__ colmap,
                        const int* __restrict__ run_ptr, int R, int RUp) {
  constexpr int kCols = NP == 1 ? 10 : 14;
  __shared__ int crow[NP][kTile];  // child row of each tile row (-1: none)
  __shared__ int ccol[NP][kTile];  // child column of each tile column
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int s0 = run_ptr[blockIdx.x];
  const int s1 = run_ptr[blockIdx.x + 1];
  const int slot = man[(size_t)s0 * kCols + 0];
  const int tr = man[(size_t)s0 * kCols + 1];
  const int tc = man[(size_t)s0 * kCols + 2];

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.0f;

  for (int s = s0; s < s1; ++s) {
    const int* m = man + (size_t)s * kCols;
    __syncthreads();  // the previous step's maps are no longer read
    if (tid < NP * kTile) {
      const int p = tid / kTile;
      const int i = tid - p * kTile;
      const int* blk = m + piece_col<NP>(p) + 1;
      crow[p][i] = child_index(rowmap[((size_t)s * NP + p) * kTile + i],
                               blk[0], blk[1]);
    } else if (tid < 2 * NP * kTile) {
      const int p = tid / kTile - NP;
      const int i = tid - (NP + p) * kTile;
      const int* blk = m + piece_col<NP>(p) + 1;
      ccol[p][i] = child_index(colmap[((size_t)s * NP + p) * kTile + i],
                               blk[2], blk[3]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int cc = ccol[p][tx];
      if ((NP == 1 && m[4] == 0) || cc < 0) continue;
      const float* Uc = U + (size_t)m[piece_col<NP>(p)] * RUp * RUp + cc;
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int rr = crow[p][ty + q * kRowPhases];
        if (rr >= 0) {
          const float v = Uc[(size_t)rr * RUp];
          acc[q] += isfinite(v) ? v : 0.0f;
        }
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

template <int NP>
int launch(void* F, const void* Ucat, const void* man, const void* rowmap,
           const void* colmap, const void* run_ptr, int nruns, int R, int RUp,
           void* stream) {
  if (nruns < 0 || R < 1 || RUp < kTile || RUp % kTile != 0)
    return (int)cudaErrorInvalidValue;
  if (nruns == 0) return 0;
  extend_add_tiles_kernel<NP><<<nruns, dim3(kTile, kRowPhases), 0,
                                (cudaStream_t)stream>>>(
      (float*)F, (const float*)Ucat, (const int*)man, (const int*)rowmap,
      (const int*)colmap, (const int*)run_ptr, R, RUp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sst_extend_add_tiles(void* F, const void* Ucat, const void* man,
                                    const void* rowmap, const void* colmap,
                                    const void* run_ptr, int nruns, int R,
                                    int RUp, void* stream) {
  return launch<1>(F, Ucat, man, rowmap, colmap, run_ptr, nruns, R, RUp,
                   stream);
}

extern "C" int sst_extend_add_tiles_pair(void* F, const void* Ucat,
                                         const void* man, const void* rowmap,
                                         const void* colmap,
                                         const void* run_ptr, int nruns,
                                         int R, int RUp, void* stream) {
  return launch<2>(F, Ucat, man, rowmap, colmap, run_ptr, nruns, R, RUp,
                   stream);
}
