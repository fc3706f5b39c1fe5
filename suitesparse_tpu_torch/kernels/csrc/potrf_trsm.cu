// Batched Cholesky panel factorization (potrf + trsm) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/potrf.py
// (batched_potrf_trsm, body _kernel, pallas_call at :108). For B prepared
// tiles (F11 symmetric with identity on padding, F21 the subdiagonal panel)
// it writes L11 = chol(F11), zero above the diagonal, and L21 = F21 L11^-T.
//
// Same arithmetic as the TPU kernel: a right-looking column loop with an
// rsqrt pivot and no pivoting. The pivot is never clamped: a non-positive
// pivot gives inf/NaN, which the factor's minor detection relies on.
//
// What bounds it on the H100: latency, not bytes. Each tile is C dependent
// column steps (C <= 96), each a short burst of shared-memory work between
// barriers; a tile moves only (C*C + RU*C) * 8 bytes. The design keeps the
// whole tile in shared memory and runs one 128-thread block per tile, so the
// serial chain of one tile overlaps with the chains of the thousands of other
// tiles of a group (B reaches 8,735 at n = 125,000) across all 132 SMs.
//
// Phase 1 factors L11 in shared memory (row stride C+1 when C is even: an odd
// stride keeps a column walk free of bank conflicts). Phase 2 stages F21 in
// chunks of 128 rows; rows are independent, so each thread runs the forward
// substitution of one row against L11, multiplying by the saved rsqrt
// pivots exactly as the TPU kernel's right-looking update does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxC = 96;

__host__ __device__ inline int odd_stride(int C) { return C + 1 - (C & 1); }

__global__ void __launch_bounds__(kThreads)
potrf_trsm_kernel(const float* __restrict__ f11, const float* __restrict__ f21,
                  float* __restrict__ l11, float* __restrict__ l21,
                  int C, int RU) {
  extern __shared__ float smem[];
  const int ld = odd_stride(C);
  float* A = smem;             // C x ld: the tile, factored in place
  float* inv = A + C * ld;     // rsqrt of each pivot
  float* Y = inv + C;          // kThreads x ld: one chunk of F21 rows
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;

  const float* src = f11 + b * C * C;
  for (int e = t; e < C * C; e += kThreads) A[(e / C) * ld + e % C] = src[e];
  __syncthreads();

  for (int k = 0; k < C; ++k) {
    const float r = rsqrtf(A[k * ld + k]);
    __syncthreads();  // every thread has read the pivot before it is scaled
    for (int i = t; i < C; i += kThreads)
      A[i * ld + k] = (i >= k) ? A[i * ld + k] * r : 0.0f;
    if (t == 0) inv[k] = r;
    __syncthreads();
    const int m = C - k - 1;
    for (int e = t; e < m * m; e += kThreads) {
      const int i = k + 1 + e / m;
      const int j = k + 1 + e % m;
      A[i * ld + j] -= A[i * ld + k] * A[j * ld + k];
    }
    __syncthreads();
  }

  float* dst = l11 + b * C * C;
  for (int e = t; e < C * C; e += kThreads) dst[e] = A[(e / C) * ld + e % C];

  if (RU == 0) return;
  const float* ysrc = f21 + b * RU * C;
  float* ydst = l21 + b * RU * C;
  for (int r0 = 0; r0 < RU; r0 += kThreads) {
    const int nr = min(kThreads, RU - r0);
    for (int e = t; e < nr * C; e += kThreads)
      Y[(e / C) * ld + e % C] = ysrc[(size_t)r0 * C + e];
    __syncthreads();
    if (t < nr) {
      float* y = Y + t * ld;
      for (int j = 0; j < C; ++j) {
        float acc = y[j];
        for (int k = 0; k < j; ++k) acc -= A[j * ld + k] * y[k];
        y[j] = acc * inv[j];
      }
    }
    __syncthreads();
    for (int e = t; e < nr * C; e += kThreads)
      ydst[(size_t)r0 * C + e] = Y[(e / C) * ld + e % C];
    __syncthreads();  // the chunk is written back before the next overwrites it
  }
}

}  // namespace

extern "C" int sst_potrf_trsm(const void* f11, const void* f21, void* l11,
                              void* l21, int B, int C, int RU, void* stream) {
  if (C < 1 || C > kMaxC || RU < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int ld = odd_stride(C);
  const size_t smem =
      sizeof(float) * ((size_t)C * ld + C + (RU > 0 ? (size_t)kThreads * ld : 0));
  cudaError_t err = cudaFuncSetAttribute(
      potrf_trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  potrf_trsm_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)f11, (const float*)f21, (float*)l11, (float*)l21, C, RU);
  return (int)cudaGetLastError();
}
