// Triangular solve of one tile in shared memory, shared by trisolve.cu (K4)
// and solve_step.cu (K3).
//
// L is a C x C lower-triangular tile at row stride ld (nonzero diagonal,
// identity on padding); X holds NR right-hand sides as C rows of NR values
// and is overwritten with L^-1 X (forward) or L^-T X (transposed).
//
// Right-looking column loop, the TPU kernels' forward order: step k takes
// x_k = X[k] / L[k][k] and subtracts L[i][k] x_k from every row i below k
// (transposed: L[k][i] x_k from every row i above k). Row k is final when
// step k starts and no thread writes it during the step, so one barrier per
// step suffices; each row is divided by its pivot in one last pass, which
// gives the same values as dividing it in the loop. The (row, column) cells
// of a step are spread over the block, columns fastest: neighbouring
// threads touch neighbouring X cells, and with an odd ld the column walk
// L[i][k] of the forward solve is free of bank conflicts.
#pragma once

#include <cuda_runtime.h>

namespace sst {

// A row stride that is odd (conflict-free column walks in shared memory).
__host__ __device__ inline int odd_stride(int C) { return C + 1 - (C & 1); }

template <bool kTranspose>
__device__ void tile_trisolve(const float* L, int ld, float* X, int C,
                              int NR) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  for (int step = 0; step < C; ++step) {
    const int k = kTranspose ? C - 1 - step : step;
    const float piv = L[k * ld + k];
    const int i0 = kTranspose ? 0 : k + 1;
    const int ni = kTranspose ? k : C - k - 1;
    for (int e = t; e < ni * NR; e += nt) {
      const int i = i0 + e / NR;
      const int r = e - (e / NR) * NR;
      const float xk = X[k * NR + r] / piv;
      const float l = kTranspose ? L[k * ld + i] : L[i * ld + k];
      X[i * NR + r] -= l * xk;
    }
    __syncthreads();
  }
  for (int e = t; e < C * NR; e += nt) {
    const int k = e / NR;
    X[e] = X[e] / L[k * ld + k];
  }
  __syncthreads();
}

// Threads of a block whose widest step has `cells` independent cells:
// whole warps, at least one, at most 256.
inline int block_threads(long cells) {
  long w = (cells + 31) / 32 * 32;
  return (int)(w < 32 ? 32 : (w > 256 ? 256 : w));
}

}  // namespace sst
