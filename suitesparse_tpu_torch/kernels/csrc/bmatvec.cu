// Batched matvec on batch-major panels (K6) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/bmatvec.py (bmatvec_t,
// bodies _fwd_kernel / _bwd_kernel, pallas_call at :138). For panels
// M (B, I, J) and right-hand sides X:
//
//   forward     Z[b] = M[b] X[b],    X (B, J, NR), Z (B, I, NR)
//   transposed  Z[b] = M[b]^T X[b],  X (B, I, NR), Z (B, J, NR)
//
// with NR <= 8 (the latency regime of the solve sweeps). The TPU kernel kept
// the panels lane-major, (I, J, B) with the batch on the 128 lanes, because
// small J wasted most of each vector register; a warp has no such waste, so
// the panels stay batch-major and the w2 sweep's W2 (B, R, C) is read as it
// is, in both directions.
//
// What bounds it on the H100: bytes. The panel is read once for 2 NR flops
// per cell; at NR <= 8 that is at most 4 flops per byte, far below the fp32
// rate. The shapes are small and many ((8735, 16, 8) holds 128 cells per
// element), so the design packs several batch elements into one block of
// 256 threads: the block stages its elements' X in shared memory (coalesced),
// and each thread owns one output row (forward) or one output column
// (transposed) of one element, keeping its NR sums in registers. Transposed,
// neighbouring threads read neighbouring columns of a panel row (coalesced);
// forward, each thread reads its own panel row, so a warp reads consecutive
// rows of one contiguous panel. When an element has fewer outputs than the
// block has threads, the remaining threads split the reduction axis into
// slices whose partial sums meet in shared memory; when it has more, the
// outputs are cut into chunks of 256 over a second grid axis. The element
// count per block keeps about 264 blocks (two per SM) where the batch allows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNR = 8;
constexpr int kTargetBlocks = 264;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads)
bmatvec_kernel(const float* __restrict__ M, const float* __restrict__ X,
               float* __restrict__ Z, int B, int I, int J, int NR, int epb,
               int w, int s) {
  extern __shared__ float smem[];
  const int ncols = kTranspose ? J : I;  // outputs per element
  const int K = kTranspose ? I : J;      // reduction length
  float* Xs = smem;                      // epb x K x NR
  float* Ps = Xs + (size_t)epb * K * NR;  // s x w x NR partial sums
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * epb;
  const int nb = min(epb, B - b0);

  const float* Xb = X + (size_t)b0 * K * NR;
  for (int e = t; e < nb * K * NR; e += kThreads) Xs[e] = Xb[e];
  __syncthreads();

  const int item = t % w;   // (element, output) of this thread
  const int slice = t / w;  // its part of the reduction axis
  const int el = gridDim.y > 1 ? 0 : item / ncols;
  const int col = gridDim.y > 1 ? blockIdx.y * w + item : item % ncols;
  const bool live = slice < s && el < nb && col < ncols;
  float acc[kMaxNR];
#pragma unroll
  for (int r = 0; r < kMaxNR; ++r) acc[r] = 0.0f;
  if (live) {
    const int k0 = (int)((long long)K * slice / s);
    const int k1 = (int)((long long)K * (slice + 1) / s);
    const float* Mb = M + (size_t)(b0 + el) * I * J;
    const float* Xe = Xs + (size_t)el * K * NR;
    for (int k = k0; k < k1; ++k) {
      const float m = kTranspose ? Mb[(size_t)k * J + col]
                                 : Mb[(size_t)col * J + k];
#pragma unroll
      for (int r = 0; r < kMaxNR; ++r)
        if (r < NR) acc[r] += m * Xe[k * NR + r];
    }
  }
  if (s > 1) {  // uniform over the block
    if (live && slice > 0)
#pragma unroll
      for (int r = 0; r < kMaxNR; ++r)
        if (r < NR) Ps[((size_t)slice * w + item) * NR + r] = acc[r];
    __syncthreads();
    if (live && slice == 0)
      for (int q = 1; q < s; ++q)
#pragma unroll
        for (int r = 0; r < kMaxNR; ++r)
          if (r < NR) acc[r] += Ps[((size_t)q * w + item) * NR + r];
  }
  if (live && slice == 0) {
    float* Zb = Z + ((size_t)(b0 + el) * ncols + col) * NR;
#pragma unroll
    for (int r = 0; r < kMaxNR; ++r)
      if (r < NR) Zb[r] = acc[r];
  }
}

template <bool kTranspose>
int launch(const float* M, const float* X, float* Z, int B, int I, int J,
           int NR, cudaStream_t stream) {
  const int ncols = kTranspose ? J : I;
  const int K = kTranspose ? I : J;
  const size_t red = sizeof(float) * kThreads * NR;
  const size_t per_el = sizeof(float) * (size_t)K * NR;
  if (per_el + red > kMaxSmem) return (int)cudaErrorInvalidValue;
  int epb = 1, w = kThreads, s = 1, gy = 1;
  if (ncols >= kThreads) {
    gy = (ncols + kThreads - 1) / kThreads;
  } else {
    epb = kThreads / ncols;
    const int spread = (B + kTargetBlocks - 1) / kTargetBlocks;
    if (spread < epb) epb = spread;
    const int room = (int)((kMaxSmem - red) / per_el);
    if (room < epb) epb = room;
    if (epb < 1) epb = 1;
    w = epb * ncols;
    s = kThreads / w;
    if (s > K) s = K;
    if (s < 1) s = 1;
  }
  const size_t smem = epb * per_el + (s > 1 ? sizeof(float) * s * w * NR : 0);
  cudaError_t err = cudaFuncSetAttribute(
      bmatvec_kernel<kTranspose>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + epb - 1) / epb, gy);
  bmatvec_kernel<kTranspose><<<grid, kThreads, smem, stream>>>(
      M, X, Z, B, I, J, NR, epb, w, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sst_bmatvec(const void* M, const void* X, void* Z, int B, int I,
                           int J, int NR, int transpose, void* stream) {
  if (B < 0 || I < 1 || J < 1 || NR < 1 || NR > kMaxNR)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (transpose)
    return launch<true>((const float*)M, (const float*)X, (float*)Z, B, I, J,
                        NR, (cudaStream_t)stream);
  return launch<false>((const float*)M, (const float*)X, (float*)Z, B, I, J,
                       NR, (cudaStream_t)stream);
}
