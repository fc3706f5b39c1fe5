// Streaming panel matvec (K5) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/pmatvec.py (pmatvec_t,
// body _kernel, pallas_call at :91). For big panels M (B, K, N) with a small
// batch and NR <= 8 right-hand sides X (B, K, NR):
//
//   Z[b] = M[b]^T X[b],   Z (B, N, NR)
//
// The w2 sweep applies its top-of-tree panels with it in both directions:
// forward through W2^T (B, C, R), backward through W2 (B, R, C). The TPU
// kernel's (8, 128) padding of K and N and its (B, NRpad8, Npad) output are
// not carried.
//
// What bounds it on the H100: bytes. Each cell of M is read once for 2 NR
// flops (at most 4 flops a byte), so the card is only as fast as the bytes
// it keeps in flight, about 32 KB on every SM, and nothing else may sit on
// the path. The design:
//
// - A thread owns 4 neighbouring columns of M and reads them with one
//   16-byte streaming load a row (ld.global.nc.L1::no_allocate: every byte
//   is read once, so it is kept out of L1). Where N % 4 != 0 or M is not
//   16-byte aligned, the same threads take 4-byte loads.
// - A column tile is `tw` (32, 16 or 8) groups of 4 columns wide, of equal
//   widths to one group, so no tile is mostly idle. The 32 lanes of a warp
//   cover the tile's groups and 32 / tw neighbouring rows: each load step
//   reads 512 bytes, and a panel of few columns still gives enough tiles.
//   A warp sums a contiguous run of `rows` rows, kUnroll steps at a time,
//   whose loads are issued together (4 KB in flight a warp); its lanes of
//   one column group add up by shuffles at the end. A batch's X rows
//   reach the warp's own slice of shared memory by 4-byte asynchronous
//   copies of its lanes, in flight beside the loads of M (no registers
//   held, no block barrier), and are read back as broadcasts. NR is a
//   template parameter: no right-hand side that is not there costs an
//   instruction. (A rolling window, each slot loading the next batch's row
//   as soon as it is summed, was no faster at NR 1 and slower at NR 8 on
//   the H100; neither was an L2 evict-first policy on the loads.)
// - K is split over the `warps` warps of a block and, where a tile needs
//   more runs than 1.5 blocks' warps, over the `split` blocks of a
//   thread-block cluster, so that about 8 warps a SM are loading:
//   (1, 3864, 3864) runs 31 column tiles times 35 runs of 111 rows, 155
//   blocks of 7 warps; (1, 2168, 504) 16 tiles of 8 groups, 64 runs each.
// - The split sums meet in the same launch, in a fixed order: each warp
//   stores its sums in shared memory (a lane's at an odd stride, so the
//   lanes' stores do not meet in one bank), the block adds its warps in
//   order, each block of a cluster stores that sum into rank 0's shared
//   memory (distributed shared memory), and after one cluster barrier rank
//   0 adds the ranks in order and writes Z. No memset, no atomics: two
//   calls on the same inputs return the same bits.
//
// The launch plan (tw, tiles, warps, split, rows, smem) is computed by
// pmv_geometry in kernels/pmatvec.py; the entry point checks it and
// recomputes the shared memory it implies.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;
constexpr int kCols = 4;      // columns a thread owns: one 16-byte word
constexpr int kUnroll = 8;    // load steps a warp has in flight
constexpr int kMaxWarps = 8;
constexpr int kMaxSplit = 8;  // a portable cluster
constexpr int kMaxRs = 4;     // rows a warp reads a step (tiles of 8 groups)
constexpr int kMaxNR = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

// floats of one warp's sums: a lane's 4 NR at an odd stride, so that the
// lanes' stores do not meet in one bank
__host__ __device__ constexpr int warp_sum_floats(int NR) {
  return kLanes * (kCols * NR + 1);
}

// warp sums | cluster sums (split > 1, read in rank 0) | per-warp X rows
size_t smem_bytes(int NR, int warps, int split) {
  const size_t tile = (size_t)kLanes * kCols * NR;
  return sizeof(float) * ((size_t)warps * warp_sum_floats(NR) +
                          (split > 1 ? split * tile : 0) +
                          (size_t)warps * kUnroll * kMaxRs * NR);
}

__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// the 4 columns at p, of which `left` (>= 1) lie inside the panel
template <bool kVec>
__device__ __forceinline__ float4 load_cols(const float* p, int left) {
  if constexpr (kVec) {
    return ld_stream(p);
  } else {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v.x = __ldg(p);
    if (left > 1) v.y = __ldg(p + 1);
    if (left > 2) v.z = __ldg(p + 2);
    if (left > 3) v.w = __ldg(p + 3);
    return v;
  }
}

template <int kNR, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 2)
pmatvec_kernel(const float* __restrict__ M, const float* __restrict__ X,
               float* __restrict__ Z, int K, int N, int tw, int tiles,
               int split, int rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTile = kLanes * kCols * kNR;  // outputs of a column tile
  constexpr int kXRows = kUnroll * kMaxRs;      // X rows a warp stages
  constexpr int kXL = (kXRows * kNR + kLanes - 1) / kLanes;  // X a lane moves
  const int warps = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  // lane -> (column group cl of the tile, row rs of each step)
  const int nrs = kLanes / tw, cl = lane % tw, rs = lane / tw;
  const int step = kUnroll * nrs;  // rows of a batch
  const int tile = blockIdx.x / split, rank = blockIdx.x % split;
  const size_t b = blockIdx.y;
  // column groups [c0, c1) of this tile
  const int nc = (N + kCols - 1) / kCols;
  const int c0 = (int)((long long)tile * nc / tiles);
  const int c1 = (int)((long long)(tile + 1) * nc / tiles);
  const int n0 = (c0 + cl) * kCols;
  const bool live = c0 + cl < c1;
  // rows [k0, k1) of this warp
  const long long run = (long long)rank * warps + w;
  const int k0 = (int)min((long long)K, run * rows);
  const int k1 = min(K, k0 + rows);

  constexpr int kLd = kCols * kNR + 1;         // a lane's sums in P
  float* P = smem;  // warps * warp_sum_floats: each warp's sums
  float* RED = P + warps * warp_sum_floats(kNR);  // split * kTile: cluster
  float* XS = RED + (split > 1 ? split * kTile : 0) + w * kXRows * kNR;

  // the cluster's blocks must all have started before one stores into
  // another's shared memory (waited for below)
  if (split > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const float* Mp = M + b * K * N + n0;
  const float* Xp = X + b * K * kNR;
  float acc[kCols][kNR];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int r = 0; r < kNR; ++r) acc[j][r] = 0.0f;

  for (int k = k0; k < k1; k += step) {
    const int nk = min(step, k1 - k);
    // rows k + u nrs + rs of the batch, all loads in flight together
    float4 m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = u * nrs + rs;
      m[u] = live && ru < nk
                 ? load_cols<kVec>(Mp + (size_t)(k + ru) * N, N - n0)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    // the batch's X rows -> this warp's XS by 4-byte asynchronous copies
    // (no registers held), zeros past the run's end
    __syncwarp();  // every lane is done with the previous batch's X
#pragma unroll
    for (int i = 0; i < kXL; ++i) {
      const int e = lane + i * kLanes;
      if (e < nk * kNR)
        cp_async4(XS + e, Xp + (size_t)k * kNR + e);
      else if (e < step * kNR)
        XS[e] = 0.0f;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* xs = XS + (u * nrs + rs) * kNR;
      float x[kNR];
      if constexpr (kNR % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kNR / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(xs)[q];
          x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z,
          x[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kNR; ++r) x[r] = xs[r];
      }
      const float mv[kCols] = {m[u].x, m[u].y, m[u].z, m[u].w};
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int r = 0; r < kNR; ++r) acc[j][r] += mv[j] * x[r];
    }
  }

  // the lanes of one column group (rows rs of each step) add up by a fixed
  // butterfly; lane rs = 0 holds the warp's sum
  for (int off = tw; off < kLanes; off *= 2)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int r = 0; r < kNR; ++r)
        acc[j][r] += __shfl_xor_sync(0xffffffffu, acc[j][r], off);

  // the warps' sums in warp order, then the cluster's in rank order. The
  // tile's outputs are contiguous in Z: e = cl * 4 NR + j NR + r, held in
  // P at e + cl
  if (rs == 0) {
    float* Pw = P + w * warp_sum_floats(kNR) + cl * kLd;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int r = 0; r < kNR; ++r) Pw[j * kNR + r] = acc[j][r];
  }
  __syncthreads();
  const int nout = (min(c1 * kCols, N) - c0 * kCols) * kNR;
  float* Zt = Z + (b * N + (size_t)c0 * kCols) * kNR;
  float* dst = RED;
  if (split > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    dst = cg::this_cluster().map_shared_rank(RED, 0) + rank * kTile;
  }
  for (int e = threadIdx.x; e < nout; e += blockDim.x) {
    const float* pe = P + e + e / (kCols * kNR);
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxWarps; ++q)
      if (q < warps) v += pe[q * warp_sum_floats(kNR)];
    if (split > 1)
      dst[e] = v;
    else
      Zt[e] = v;
  }
  if (split > 1) {
    cg::this_cluster().sync();  // every rank's sums are in rank 0's RED
    if (rank == 0)
      for (int e = threadIdx.x; e < nout; e += blockDim.x) {
        float v = 0.0f;
#pragma unroll
        for (int p = 0; p < kMaxSplit; ++p)
          if (p < split) v += RED[p * kTile + e];
        Zt[e] = v;
      }
  }
}

template <int kNR, bool kVec>
int launch(const float* M, const float* X, float* Z, int B, int K, int N,
           int tw, int tiles, int warps, int split, int rows, int smem,
           cudaStream_t stream) {
  auto kernel = pmatvec_kernel<kNR, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split, B);
  cfg.blockDim = dim3(warps * kLanes);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, M, X, Z, K, N, tw, tiles, split,
                           rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_nr(int NR, const float* M, const float* X, float* Z, int B, int K,
              int N, int tw, int tiles, int warps, int split, int rows,
              int smem, cudaStream_t stream) {
#define SST_PMV_NR(n)                                                   \
  case n:                                                               \
    return launch<n, kVec>(M, X, Z, B, K, N, tw, tiles, warps, split, \
                           rows, smem, stream);
  switch (NR) {
    SST_PMV_NR(1)
    SST_PMV_NR(2)
    SST_PMV_NR(3)
    SST_PMV_NR(4)
    SST_PMV_NR(5)
    SST_PMV_NR(6)
    SST_PMV_NR(7)
    SST_PMV_NR(8)
  }
#undef SST_PMV_NR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sst_pmatvec(const void* M, const void* X, void* Z, int B, int K,
                           int N, int NR, int vec, int tw, int tiles,
                           int warps, int split, int rows, int smem,
                           void* stream) {
  if (B < 0 || B > 65535 || K < 0 || N < 0 || NR < 1 || NR > kMaxNR)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const int nc = (N + kCols - 1) / kCols;
  const bool aligned = (reinterpret_cast<uintptr_t>(M) & 15) == 0;
  const bool ok =
      (tw == 8 || tw == 16 || tw == 32) && tiles >= 1 && tiles <= nc &&
      (long long)tiles * tw >= nc &&
      warps >= 1 && warps <= kMaxWarps && split >= 1 && split <= kMaxSplit &&
      (long long)tiles * split <= INT_MAX && rows >= 1 &&
      (long long)rows * warps * split >= K && (vec == 0 || vec == 1) &&
      (!vec || (N % kCols == 0 && aligned)) && smem >= 0 &&
      (size_t)smem <= kMaxSmem && (size_t)smem == smem_bytes(NR, warps, split);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (vec)
    return launch_nr<true>(NR, (const float*)M, (const float*)X, (float*)Z, B,
                           K, N, tw, tiles, warps, split, rows, smem,
                           (cudaStream_t)stream);
  return launch_nr<false>(NR, (const float*)M, (const float*)X, (float*)Z, B,
                          K, N, tw, tiles, warps, split, rows, smem,
                          (cudaStream_t)stream);
}
