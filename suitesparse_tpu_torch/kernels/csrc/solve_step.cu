// Fused per-group solve steps (K3) of the classic multifrontal solve sweep
// for Hopper (sm_90a).
//
// Replaces the Pallas kernels suitesparse_tpu/kernels/solve_step.py
// (solve_step_fwd / solve_step_bwd, bodies _fwd_kernel / _bwd_kernel,
// pallas_calls at :96 and :108). Per batch element b of a solve group, with
// L11 (C, C) lower-triangular (identity on padding) and L21 (RU, C):
//
//   forward:   xc = L11^-1 y,  v = wb + L21 xc       (v goes to the parent)
//   backward:  xc = L11^-T (y - L21^T xb)
//
// What bounds it on the H100: bytes, then latency. A step reads its panel
// once ((C*C + RU*C) * 4 bytes; 305 KB at C = 96, RU = 720) against
// 2 * (C*C/2 + RU*C) * NR flops, so at NR = 1 and NR = 64 the panel read
// dominates the arithmetic; at small C the C dependent column steps of the
// triangular solve set the time. The design runs one block per batch
// element: L11 and the right-hand sides sit in shared memory for the
// triangular solve (tile_trisolve.cuh); L21, up to 720 x 96 and too large for
// shared memory, is streamed from device memory once. Forward, the block
// solves xc, then stages L21 in chunks of 64 rows with coalesced loads and
// each thread takes cells (row of v, column) of the product, summing over k
// in the TPU kernel's order. Backward, each thread first forms one cell of
// y - L21^T xb as a sum over the RU rows, reading L21 and xb in coalesced
// rows, then the block solves the transposed system. L21 and the vectors
// wb / xb may have any batch stride (they are views into the packed factor
// and the sweep's work buffers); their rows must be contiguous.

#include <cuda_runtime.h>

#include "tile_trisolve.cuh"

namespace {

constexpr int kMaxC = 96;
constexpr int kChunk = 64;           // L21 rows staged per pass (forward)
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

size_t fwd_smem(int C, int RU, int NR) {
  const size_t ld = sst::odd_stride(C);
  const size_t rows = RU < kChunk ? RU : kChunk;
  return sizeof(float) * (C * ld + (size_t)C * NR + rows * ld);
}

size_t bwd_smem(int C, int NR) {
  return sizeof(float) * ((size_t)C * sst::odd_stride(C) + (size_t)C * NR);
}

__global__ void solve_step_fwd_kernel(
    const float* __restrict__ L11, const float* __restrict__ L21,
    long long l21_bstride, const float* __restrict__ Y,
    const float* __restrict__ WB, long long wb_bstride,
    float* __restrict__ XC, float* __restrict__ V, int C, int RU, int NR) {
  extern __shared__ float smem[];
  const int ld = sst::odd_stride(C);
  float* Ls = smem;             // C x ld: L11
  float* Xs = Ls + C * ld;      // C x NR: y, then xc
  float* Ps = Xs + C * NR;      // kChunk x ld: rows of L21
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;

  const float* Lb = L11 + b * C * C;
  const float* Yb = Y + b * C * NR;
  for (int e = t; e < C * C; e += nt) Ls[(e / C) * ld + e % C] = Lb[e];
  for (int e = t; e < C * NR; e += nt) Xs[e] = Yb[e];
  __syncthreads();

  sst::tile_trisolve<false>(Ls, ld, Xs, C, NR);

  float* Xb = XC + b * C * NR;
  for (int e = t; e < C * NR; e += nt) Xb[e] = Xs[e];

  const float* Pb = L21 + b * l21_bstride;
  const float* Wb = WB + b * wb_bstride;
  float* Vb = V + b * (size_t)RU * NR;
  for (int r0 = 0; r0 < RU; r0 += kChunk) {
    const int nr = min(kChunk, RU - r0);
    for (int e = t; e < nr * C; e += nt)
      Ps[(e / C) * ld + e % C] = Pb[(size_t)r0 * C + e];
    __syncthreads();
    for (int e = t; e < nr * NR; e += nt) {
      const int j = e / NR;
      const int r = e - j * NR;
      float acc = Wb[(size_t)(r0 + j) * NR + r];
      for (int k = 0; k < C; ++k) acc += Ps[j * ld + k] * Xs[k * NR + r];
      Vb[(size_t)(r0 + j) * NR + r] = acc;
    }
    __syncthreads();  // the chunk is used up before the next overwrites it
  }
}

__global__ void solve_step_bwd_kernel(
    const float* __restrict__ L11, const float* __restrict__ L21,
    long long l21_bstride, const float* __restrict__ Y,
    const float* __restrict__ XB, long long xb_bstride,
    float* __restrict__ XC, int C, int RU, int NR) {
  extern __shared__ float smem[];
  const int ld = sst::odd_stride(C);
  float* Ls = smem;             // C x ld: L11
  float* Xs = Ls + C * ld;      // C x NR: y - L21^T xb, then xc
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;

  const float* Lb = L11 + b * C * C;
  for (int e = t; e < C * C; e += nt) Ls[(e / C) * ld + e % C] = Lb[e];
  const float* Yb = Y + b * C * NR;
  const float* Pb = L21 + b * l21_bstride;
  const float* Xbb = XB + b * xb_bstride;
  for (int e = t; e < C * NR; e += nt) {
    const int k = e / NR;
    const int r = e - k * NR;
    float acc = Yb[e];
    for (int j = 0; j < RU; ++j)
      acc -= Pb[(size_t)j * C + k] * Xbb[(size_t)j * NR + r];
    Xs[e] = acc;
  }
  __syncthreads();

  sst::tile_trisolve<true>(Ls, ld, Xs, C, NR);

  float* Xb = XC + b * C * NR;
  for (int e = t; e < C * NR; e += nt) Xb[e] = Xs[e];
}

int launch_checks(int B, int C, int RU, int NR, size_t smem) {
  if (B < 0 || C < 1 || C > kMaxC || RU < 0 || NR < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int sst_solve_step_fwd(const void* L11, const void* L21,
                                  long long l21_bstride, const void* Y,
                                  const void* WB, long long wb_bstride,
                                  void* XC, void* V, int B, int C, int RU,
                                  int NR, void* stream) {
  const size_t smem = fwd_smem(C, RU, NR);
  if (int err = launch_checks(B, C, RU, NR, smem)) return err;
  if (B == 0) return 0;
  const int rows = RU < kChunk ? RU : kChunk;
  const int threads = sst::block_threads((long)(rows > C ? rows : C) * NR);
  cudaError_t err = cudaFuncSetAttribute(
      solve_step_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_step_fwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)L11, (const float*)L21, l21_bstride, (const float*)Y,
      (const float*)WB, wb_bstride, (float*)XC, (float*)V, C, RU, NR);
  return (int)cudaGetLastError();
}

extern "C" int sst_solve_step_bwd(const void* L11, const void* L21,
                                  long long l21_bstride, const void* Y,
                                  const void* XB, long long xb_bstride,
                                  void* XC, int B, int C, int RU, int NR,
                                  void* stream) {
  const size_t smem = bwd_smem(C, NR);
  if (int err = launch_checks(B, C, RU, NR, smem)) return err;
  if (B == 0) return 0;
  const int threads = sst::block_threads((long)C * NR);
  cudaError_t err = cudaFuncSetAttribute(
      solve_step_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_step_bwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)L11, (const float*)L21, l21_bstride, (const float*)Y,
      (const float*)XB, xb_bstride, (float*)XC, C, RU, NR);
  return (int)cudaGetLastError();
}
