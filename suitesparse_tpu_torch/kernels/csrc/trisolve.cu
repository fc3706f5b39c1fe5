// Batched small triangular solve (K4) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/trisolve.py
// (batched_trisolve, body _kernel, pallas_call at :89). For B lower-
// triangular fp32 tiles L (B, C, C), C <= 96, with a nonzero diagonal and
// right-hand sides Y (B, C, NR) it writes X = L^-1 Y, or X = L^-T Y when
// `transpose` is set. It reads L's lower triangle and diagonal only: the
// classic sweep's padded tiles promise nothing above the diagonal.
//
// What bounds it on the H100. Bytes do not: a tile moves (C*C/2 + 2*C*NR)*4
// bytes for C*C*NR/2 multiply-adds, 0.0063 ms for all of (512, 64, 64) at
// 3.35 TB/s and 0.0013 ms at NR 1. What does:
// - NR 64: instruction issue. A tile is C*C*NR/2 FMAs (131,072 at
//   (64, 64)); spent one loop iteration per (row, column) cell, with index
//   divisions, a pivot division and three shared-memory accesses around
//   each FMA (the shared per-cell loop this kernel replaced), the
//   issue slots run out long before the bytes.
// - NR 1: latency. Each tile has only C cells a step and is a chain of C
//   dependent steps; the launch and one round trip to device memory for
//   the tile cost about as much again.
// The design (the warp solve lives in warp_trisolve.cuh, shared with K3):
// - A warp owns `cpw` columns of one tile's X for the whole solve, in
//   registers: lane l holds rows l, l + 32 and l + 64 (kRPL = ceil(C/32)) of
//   each. Step k needs no block barrier: the lane that owns row k publishes
//   its cells (a shuffle at cpw 1; at cpw 8 two 16-byte stores into a
//   double-buffered row of the warp's own, a __syncwarp, and two 16-byte
//   broadcast loads), and every lane then updates its rows below k (above
//   k, transposed) with one shared-memory load of L per row, reused across
//   the warp's columns: the reuse a blocked trsm gets.
// - No division in the loop. Each warp takes its tile's pivot reciprocals
//   once, into a row of shared memory of its own (no block barrier); step
//   k multiplies the lane's L values by 1 / L[k][k] (a multiply a row, not
//   one a cell) and subtracts (L[i][k] / L[k][k]) X[k] from the unscaled
//   X[k], which keeps the multiply off the chain of steps; each row is
//   multiplied by its reciprocal once at the end. That rounds differently
//   from the plain version's X[k] / L[k][k] by an ulp or two. The columns a
//   warp holds and the rows a lane holds are template parameters, so no
//   index is divided either; NR wider than the warps of a tile take
//   column chunks in turn.
// - Small NR packs several tiles into a block, one warp (or a few) each,
//   where the batch is large enough to still fill the card; NR 1 runs one
//   warp a tile, not a block of mostly idle threads. A few tiles with more
//   column chunks than a block has warps spread them over several blocks
//   (the grid's y), each with its own copy of the tile.
// - L's lower triangle moves by asynchronous 4-byte copies (cp.async), all
//   of a tile in flight at once, a warp's lanes on neighbouring words of a
//   row, into an odd row stride (a bulk copy or a 16-byte one needs a
//   stride of whole 16-byte words): the forward solve's walk down a column
//   (lane i reads L[i][k]) is then free of bank conflicts, and the
//   transposed walk along row k is anyway. The first chunk of Y is loaded
//   into registers meanwhile.
// - True fp32 FMAs, no tensor cores: the classic sweep's residual gates
//   (1e-5) would not survive TF32.
// The launch plan (tiles a block, warps a tile, columns a warp, chunks,
// shared memory) is trisolve_geometry in kernels/trisolve.py; the entry
// point checks it and recomputes the shared memory it implies.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_trisolve.cuh"

namespace {

constexpr int kMaxC = 96;
constexpr int kMaxWarps = 8;     // warps of one block
constexpr int kWide = 8;         // columns a warp holds when it holds several
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

// each warp's publish buffer and pivot reciprocals (C) | tiles (C x ld)
size_t smem_bytes(int C, int tpb, int wpt, int cpw) {
  return sizeof(float) * ((size_t)tpb * wpt * (sst::pub_floats(cpw) + C) +
                          (size_t)tpb * C * sst::odd_stride(C));
}

// The block's nt tiles into shared memory (see the note above): the lower
// triangle of tile t at Ls + t*C*ld, diagonal included, by asynchronous
// 4-byte copies, all in flight at once. Nothing above the diagonal is read.
__device__ void stage(const float* __restrict__ Lg, float* Ls, int nt, int C,
                      int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const size_t CC = (size_t)C * C;
  for (int t = 0; t < nt; ++t)
    for (int i = warp; i < C; i += nw)
      for (int c = lane; c <= i; c += 32)
        sst::cp_async4(Ls + t * C * ld + i * ld + c, Lg + t * CC + i * C + c);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Block (x, y): tpb tiles, wpt warps each; warp w of tile t takes the
// column chunks w + wpt y, w + wpt (y + csplit), ... of kCPW columns each,
// csplit = gridDim.y. At most 128 registers a thread: every instance then
// compiles without spills (under __launch_bounds__(256) ptxas spilled the
// 3-row, 8-column ones; under (256, 1) it did not, but they ran slower on
// the H100).
template <bool kT, int kRPL, int kCPW>
__global__ void __maxnreg__(128)
trisolve_kernel(const float* __restrict__ L, const float* __restrict__ Y,
                float* __restrict__ X, int B, int C, int NR, int tpb, int wpt,
                int chunks) {
  extern __shared__ __align__(16) float smem[];
  const int ld = sst::odd_stride(C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pub = smem;
  float* rinv = pub + tpb * wpt * sst::pub_floats(kCPW);
  float* Ls = rinv + tpb * wpt * C;
  const long long b0 = (long long)blockIdx.x * tpb;
  const int nt = (int)min((long long)tpb, B - b0);
  const int t = warp / wpt, w = warp - t * wpt;
  const int ch0 = w + wpt * blockIdx.y, chstep = wpt * gridDim.y;
  const size_t base = (size_t)(b0 + t) * C * NR;
  // 16-byte moves of X where every chunk's row starts 16-byte aligned
  const bool vec = kCPW % 4 == 0 && NR % 4 == 0 && sst::aligned16(Y) &&
                   sst::aligned16(X);
  float x[kRPL][kCPW];
  if (t < nt && ch0 < chunks)  // its loads fly while the tiles are staged
    sst::load_cells<kRPL, kCPW>(x, Y + base + ch0 * kCPW, C, NR, ch0 * kCPW,
                                lane, vec);
  stage(L + b0 * C * C, Ls, nt, C, ld);
  if (t >= nt) return;
  const float* St = Ls + t * C * ld;
  // the warp's own copy of the pivots' reciprocals: no block barrier
  float* rw = rinv + warp * C;
  for (int k = lane; k < C; k += 32) rw[k] = 1.0f / St[k * ld + k];
  __syncwarp();
  float* buf = pub + warp * sst::pub_floats(kCPW);
  for (int ch = ch0; ch < chunks; ch += chstep) {
    const int c0 = ch * kCPW;
    if (ch != ch0)
      sst::load_cells<kRPL, kCPW>(x, Y + base + c0, C, NR, c0, lane, vec);
    sst::solve_cells<kT, kRPL, kCPW>(x, St, rw, ld, C, lane, buf);
    sst::store_cells<kRPL, kCPW>(x, rw, X + base + c0, C, NR, c0, lane, vec);
  }
}

// trisolve_geometry's launch plan
struct Plan {
  int tpb, wpt, cpw, chunks, csplit, smem;
};

template <bool kT, int kRPL, int kCPW>
int launch(const float* L, const float* Y, float* X, int B, int C, int NR,
           const Plan& p, cudaStream_t stream) {
  auto kernel = trisolve_kernel<kT, kRPL, kCPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((B + p.tpb - 1) / p.tpb, p.csplit), 32 * p.tpb * p.wpt,
           p.smem, stream>>>(L, Y, X, B, C, NR, p.tpb, p.wpt, p.chunks);
  return (int)cudaGetLastError();
}

template <bool kT, int kRPL>
int launch_cpw(const float* L, const float* Y, float* X, int B, int C, int NR,
               const Plan& p, cudaStream_t stream) {
  if (p.cpw == 1) return launch<kT, kRPL, 1>(L, Y, X, B, C, NR, p, stream);
  return launch<kT, kRPL, kWide>(L, Y, X, B, C, NR, p, stream);
}

template <bool kT>
int launch_rpl(const float* L, const float* Y, float* X, int B, int C, int NR,
               const Plan& p, cudaStream_t stream) {
  switch ((C + 31) / 32) {
    case 1:
      return launch_cpw<kT, 1>(L, Y, X, B, C, NR, p, stream);
    case 2:
      return launch_cpw<kT, 2>(L, Y, X, B, C, NR, p, stream);
    default:
      return launch_cpw<kT, 3>(L, Y, X, B, C, NR, p, stream);
  }
}

}  // namespace

extern "C" int sst_trisolve(const void* L, const void* Y, void* X, int B,
                            int C, int NR, int transpose, int tpb, int wpt,
                            int cpw, int chunks, int csplit, int smem,
                            void* stream) {
  if (B < 0 || C < 1 || C > kMaxC || NR < 1) return (int)cudaErrorInvalidValue;
  // every block of a tile takes at least one chunk
  const bool ok = tpb >= 1 && wpt >= 1 && tpb * wpt <= kMaxWarps &&
                  (cpw == 1 || cpw == kWide) &&
                  chunks == (NR + cpw - 1) / cpw && wpt <= chunks &&
                  csplit >= 1 && (long long)(csplit - 1) * wpt < chunks &&
                  csplit <= 65535 && smem >= 0 &&
                  (size_t)smem <= kMaxSmem &&
                  (size_t)smem == smem_bytes(C, tpb, wpt, cpw);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Plan p{tpb, wpt, cpw, chunks, csplit, smem};
  if (transpose)
    return launch_rpl<true>((const float*)L, (const float*)Y, (float*)X, B, C,
                            NR, p, (cudaStream_t)stream);
  return launch_rpl<false>((const float*)L, (const float*)Y, (float*)X, B, C,
                           NR, p, (cudaStream_t)stream);
}
