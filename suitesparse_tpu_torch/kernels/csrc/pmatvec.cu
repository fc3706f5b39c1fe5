// Streaming panel matvec (K5) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/pmatvec.py (pmatvec_t,
// body _kernel, pallas_call at :91). For big panels M (B, K, N) with a small
// batch (B <= 32) and NR <= 8 right-hand sides X (B, K, NR):
//
//   Z[b] = M[b]^T X[b],   Z (B, N, NR)
//
// The w2 sweep applies its top-of-tree panels with it in both directions:
// forward through W2^T (B, C, R), backward through W2 (B, R, C). The TPU
// kernel's (8, 128) padding of K and N and its (B, NRpad8, Npad) output are
// not carried.
//
// What bounds it on the H100: bytes. The panel (up to 60 MB at
// (1, 3864, 3864)) is read once for 2 NR flops per cell. One block per
// output tile would leave most of the 132 SMs idle at B = 1, so the design
// splits K over blocks as well: block (n, k, b) owns 256 output columns and
// a chunk of K rows, stages the chunk's X rows in shared memory, and each
// thread streams its column down the chunk (neighbouring threads on
// neighbouring addresses: every warp load is one 128-byte line), with its NR
// sums in registers. The chunk length is set so that about four blocks per
// SM run (at least 32 rows, at most 1024); the partial sums of the chunks
// meet in Z through atomicAdd, after the entry point zeroes Z on the same
// stream. Atomic sums make the last bits of Z depend on the order the
// blocks finish in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // output columns per block
constexpr int kMaxNR = 8;
constexpr int kTargetBlocks = 528;
constexpr int kMinRows = 32;
constexpr int kMaxRows = 1024;  // X chunk in shared memory: 32 KB at NR = 8

__global__ void __launch_bounds__(kThreads)
pmatvec_kernel(const float* __restrict__ M, const float* __restrict__ X,
               float* __restrict__ Z, int K, int N, int NR, int rows) {
  __shared__ float Xs[kMaxRows * kMaxNR];
  const int t = threadIdx.x;
  const size_t b = blockIdx.z;
  const int k0 = blockIdx.y * rows;
  const int nk = min(rows, K - k0);
  const int n = blockIdx.x * kThreads + t;

  const float* Xb = X + (b * K + k0) * NR;
  for (int e = t; e < nk * NR; e += kThreads) Xs[e] = Xb[e];
  __syncthreads();
  if (n >= N) return;

  const float* Mc = M + (b * K + k0) * N + n;
  float acc[kMaxNR];
#pragma unroll
  for (int r = 0; r < kMaxNR; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    const float m = Mc[(size_t)k * N];
#pragma unroll
    for (int r = 0; r < kMaxNR; ++r)
      if (r < NR) acc[r] += m * Xs[k * NR + r];
  }
  float* Zc = Z + (b * N + n) * NR;
#pragma unroll
  for (int r = 0; r < kMaxNR; ++r)
    if (r < NR) atomicAdd(Zc + r, acc[r]);
}

}  // namespace

extern "C" int sst_pmatvec(const void* M, const void* X, void* Z, int B, int K,
                           int N, int NR, void* stream) {
  if (B < 0 || B > 65535 || K < 0 || N < 0 || NR < 1 || NR > kMaxNR)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(Z, 0, sizeof(float) * B * N * NR, st);
  if (err != cudaSuccess || K == 0) return (int)err;
  const int ncb = (N + kThreads - 1) / kThreads;
  const long long tiles = (long long)B * ncb;
  const int split = (int)((kTargetBlocks + tiles - 1) / tiles);
  int rows = (K + split - 1) / split;
  if (rows < kMinRows) rows = kMinRows;
  if (rows > kMaxRows) rows = kMaxRows;
  const dim3 grid(ncb, (K + rows - 1) / rows, B);
  pmatvec_kernel<<<grid, kThreads, 0, st>>>((const float*)M, (const float*)X,
                                            (float*)Z, K, N, NR, rows);
  return (int)cudaGetLastError();
}
