// Tiled multifrontal extend-add for Hopper (sm_90a), one or two pieces per
// manifest step.
//
// Replaces the Pallas kernels suitesparse_tpu/kernels/extend_add_tiles.py
// (extend_add_tiles; one-piece body _kernel, pallas_call at :381, and
// two-piece body _kernel2, pallas_call at :359). A manifest (built on the
// host by build_group_manifest) lists, for every lower T x T tile of the
// parent fronts F that receives child updates, the steps that add child
// updates ("pieces") into it; the steps of one tile are consecutive, and
// run_ptr holds the first step of each tile's run. A piece adds P_r U P_c^T
// into the tile: tile row i takes child row
//   (rm[i] < T ? blkr : blkr2) * T + rm[i] % T
// of the child's update block in Ucat (columns likewise from colmap and
// blkc/blkc2); -1 in a map means no entry. The tile width T is 128, or 256
// for the groups the plan gives wide tiles (tile_big); both widths are
// instances of one template, under the same rules. A non-finite child cell counts as
// zero (upper cells of a lower-only-assembled child hold no valid data).
// Tiles without pieces are never visited and keep their content.
//
// Two manifest forms (NP pieces per step):
//   NP = 1, 10 columns: slot tr tc init has_piece uslot blkr blkr2 blkc blkc2
//   NP = 2, 14 columns: slot tr tc init, then uslot blkr blkr2 blkc blkc2 of
//           piece 0 and of piece 1; a dead second piece has all-(-1) maps.
// The maps are (NS, NP, T).
//
// What bounds it on the H100: bytes. A piece moves up to 64 KB of child
// cells for 16 K additions, and each visited tile of F, 64 KB, is read and
// written once. But 44 of the factor's 73 manifests have fewer than 132
// tiles, so on most launches the time is the latency of a tile's chain of
// dependent loads, not the bytes. The design:
//
// - A tile's T rows are cut into `split` row slabs (4, 8 or 16 at T = 128;
//   8, 16 or 32 at T = 256), each a block of 4 warps; a warp owns RW = 8, 4
//   or 2 neighbouring rows (a template parameter) and all T columns, a lane
//   the columns lane + 32 k (T / 32 of them), so a warp's RW x T / 32 sums
//   a lane stay in registers at either width. Warps share nothing: no block barrier, no atomics (runs own
//   disjoint tiles and warps disjoint rows), so a few tiles still put many
//   warps on the card.
// - A warp walks its run's pieces in manifest order (a two-piece step is
//   two pieces; its maps' rows are already in that order). It reads the
//   run's bounds, then each piece's manifest fields and the maps of its own
//   rows (as 16- or 8-byte words) and lanes straight into registers, one
//   piece ahead of the gathers: a run costs a round trip for its bounds,
//   one for the first piece's maps and one a piece for the gathers, which
//   the next piece's maps ride along with. A piece's child cells (RW x
//   T / 32 a lane) are all loaded, predicated on the maps, before any is added; a
//   warp's loads of one row are one 128-byte line where the child columns
//   are contiguous, and they bypass L1 (ld.global.nc.L1::no_allocate:
//   every child cell is read once). Gathering two pieces at once (more
//   registers, fewer blocks an SM), L1-allocating loads and an early
//   return for warps whose rows lie past R were tried on the H100 and
//   made the factor no faster.
// - The warp's rows of F are copied into its own slice of shared memory by
//   asynchronous copies issued before the first gather, 16-byte words
//   (T / 128 of them a lane) where R % 4 == 0 and F is 16-byte aligned
//   (4 bytes at a time otherwise, same kernel), so they are in flight beside the gathers and hold no
//   registers. At the end the warp adds its sums into that slice and
//   stores the rows once, in the same width.
// - Within a cell the pieces are added in manifest order into a register
//   sum that starts at +0, and F gets the sum once: the one- and two-piece
//   forms give the same bits at either width, and so do two calls.
//
// The TPU kernels' one-hot placement dots and their SMEM chunking are not
// needed: a lane loads the child cell its maps name directly. The launch
// plan (split) is computed by tile_geometry in kernels/extend_add_tiles.py;
// the entry points check it.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;                 // warps of a block
constexpr int kVec = 4;                   // floats of a 16-byte word

template <int T>
constexpr int kLaneCols = T / kLanes;     // columns a lane owns

template <int T>
__device__ __forceinline__ int child_index(int v, int blk, int blk2) {
  return v < 0 ? -1 : (v < T ? blk : blk2) * T + (v & (T - 1));
}

// *p where ok, else 0; a streaming load that does not allocate in L1
__device__ __forceinline__ float ld_cell(const float* p, bool ok) {
  float v;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t"
      "@q ld.global.nc.L1::no_allocate.f32 %0, [%1];\n\t}"
      : "=f"(v)
      : "l"(p), "r"((int)ok));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One piece as a warp reads it: the manifest fields, the row map of the
// warp's RW rows and the column map of the lane's T / 32 columns; blkr ==
// -1 marks a piece that adds nothing.
template <int T, int RW>
struct Piece {
  int uslot, blkr, blkr2, blkc, blkc2;
  int rm[RW];
  int cm[kLaneCols<T>];
};

// piece j of the manifest (step j / NP, piece j % NP; the maps' rows are
// the pieces in that order) for the warp whose first tile row is row0; a
// piece at or past j1, the run's end, is dead and nothing of it is read
template <int T, int NP, int RW>
__device__ __forceinline__ void load_piece(Piece<T, RW>& x,
                                           const int* __restrict__ man,
                                           const int* __restrict__ rowmap,
                                           const int* __restrict__ colmap,
                                           int j, int j1, int row0, int lane) {
  constexpr int kCols = NP == 1 ? 10 : 14;
  x.uslot = 0;
  x.blkr = -1;
  if (j >= j1) return;
  const int* m = man + (size_t)(j / NP) * kCols;
  const int* mp = m + (NP == 1 ? 5 : 4 + 5 * (j % NP));
  x.uslot = __ldg(mp);
  x.blkr = __ldg(mp + 1);
  x.blkr2 = __ldg(mp + 2);
  x.blkc = __ldg(mp + 3);
  x.blkc2 = __ldg(mp + 4);
  // a step without a piece (one-piece form, has_piece == 0) adds nothing
  if (NP == 1 && __ldg(m + 4) == 0) x.blkr = -1;
  const int* rm = rowmap + (size_t)j * T + row0;
  if constexpr (RW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RW; i += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(rm + i));
      x.rm[i] = v.x;
      x.rm[i + 1] = v.y;
      x.rm[i + 2] = v.z;
      x.rm[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RW; i += 2) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(rm + i));
      x.rm[i] = v.x;
      x.rm[i + 1] = v.y;
    }
  }
#pragma unroll
  for (int k = 0; k < kLaneCols<T>; ++k)
    x.cm[k] = __ldg(colmap + (size_t)j * T + lane + k * kLanes);
}

// acc += the piece's cells; every load first
template <int T, int RW>
__device__ __forceinline__ void add_piece(float (&acc)[RW][kLaneCols<T>],
                                          const Piece<T, RW>& x,
                                          const float* __restrict__ U,
                                          int RUp) {
  constexpr int kLC = kLaneCols<T>;
  const float* Us = U + (size_t)x.uslot * RUp * RUp;
  int cc[kLC];
#pragma unroll
  for (int k = 0; k < kLC; ++k)
    cc[k] = child_index<T>(x.cm[k], x.blkc, x.blkc2);
  float v[RW][kLC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int cr =
        x.blkr < 0 ? -1 : child_index<T>(x.rm[i], x.blkr, x.blkr2);
    const float* Ur = Us + (ptrdiff_t)cr * RUp;
#pragma unroll
    for (int k = 0; k < kLC; ++k)
      v[i][k] = ld_cell(Ur + cc[k], cr >= 0 && cc[k] >= 0);
  }
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int k = 0; k < kLC; ++k)
      acc[i][k] += isfinite(v[i][k]) ? v[i][k] : 0.0f;
}

// blocks of 4 warps an SM: the register budget a thread gets (65536 /
// (128 x this)); a piece's loads, the sums and two pieces' maps live at
// once, RW x T / 32 of each of the first two
template <int T, int RW>
constexpr int kMinBlocks = T == 128 ? (RW == 2 ? 5 : 4)
                                    : (RW == 8 ? 2 : RW == 4 ? 3 : 4);

template <int T, int NP, int RW>
__global__ void __launch_bounds__(kWarps * kLanes, kMinBlocks<T, RW>)
extend_add_tiles_kernel(float* __restrict__ F, const float* __restrict__ U,
                        const int* __restrict__ man,
                        const int* __restrict__ rowmap,
                        const int* __restrict__ colmap,
                        const int* __restrict__ run_ptr, int R, int RUp,
                        int split, int vec) {
  constexpr int kCols = NP == 1 ? 10 : 14;
  constexpr int kLC = kLaneCols<T>;
  __shared__ __align__(16) float fs[kWarps][RW][T];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int run = blockIdx.x / split;
  const int row0 = ((blockIdx.x - run * split) * kWarps + warp) * RW;
  const int s0 = __ldg(run_ptr + run), s1 = __ldg(run_ptr + run + 1);
  const int* m0 = man + (size_t)s0 * kCols;
  const int slot = __ldg(m0), tr = __ldg(m0 + 1), tc = __ldg(m0 + 2);
  const int j1 = s1 * NP;  // the run's pieces are [s0 * NP, j1)
  Piece<T, RW> cur;
  load_piece<T, NP, RW>(cur, man, rowmap, colmap, s0 * NP, j1, row0, lane);
  const int r0 = tr * T + row0, c0 = tc * T;
  // a warp whose rows all lie past R (the tile's last rows) adds nothing;
  // it skips the pieces rather than return, so that no warp's first maps
  // wait for the tile's coordinates
  const int jend = r0 < R ? j1 : 0;

  // the warp's rows of F into its slice of shared memory, in flight beside
  // the gathers: a lane's 16-byte words cover its kLC columns from kLC *
  // lane (R % 4 == 0, so a word that starts inside R ends inside it)
  float* fw = &fs[warp][0][0];
  float* Fs = F + (size_t)slot * R * R;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (r0 + i >= R) break;
    const float* Fr = Fs + (size_t)(r0 + i) * R + c0;
    if (vec) {
#pragma unroll
      for (int h = 0; h < kLC; h += kVec)
        if (c0 + kLC * lane + h < R)
          cp_async16(fw + i * T + kLC * lane + h, Fr + kLC * lane + h);
    } else {
#pragma unroll
      for (int k = 0; k < kLC; ++k)
        if (c0 + lane + k * kLanes < R)
          cp_async4(fw + i * T + lane + k * kLanes, Fr + lane + k * kLanes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc[RW][kLC];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int k = 0; k < kLC; ++k) acc[i][k] = 0.0f;
  for (int j = s0 * NP; j < jend; ++j) {
    Piece<T, RW> nxt;
    load_piece<T, NP, RW>(nxt, man, rowmap, colmap, j + 1, j1, row0, lane);
    add_piece<T, RW>(acc, cur, U, RUp);
    cur = nxt;
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int k = 0; k < kLC; ++k) fw[i * T + lane + k * kLanes] += acc[i][k];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (r0 + i >= R) break;
    float* Fr = Fs + (size_t)(r0 + i) * R + c0;
    if (vec) {
#pragma unroll
      for (int h = 0; h < kLC; h += kVec)
        if (c0 + kLC * lane + h < R)
          *reinterpret_cast<float4*>(Fr + kLC * lane + h) =
              *reinterpret_cast<const float4*>(fw + i * T + kLC * lane + h);
    } else {
#pragma unroll
      for (int k = 0; k < kLC; ++k)
        if (c0 + lane + k * kLanes < R)
          Fr[lane + k * kLanes] = fw[i * T + lane + k * kLanes];
    }
  }
}

template <int T, int NP, int RW>
int launch(float* F, const float* U, const int* man, const int* rowmap,
           const int* colmap, const int* run_ptr, int nruns, int R, int RUp,
           int split, int vec, cudaStream_t stream) {
  extend_add_tiles_kernel<T, NP, RW><<<nruns * split, kWarps * kLanes, 0,
                                       stream>>>(F, U, man, rowmap, colmap,
                                                 run_ptr, R, RUp, split, vec);
  return (int)cudaGetLastError();
}

// the instance of tile width T whose split (T / (kWarps * RW) slabs a
// tile) is `split`, or null
template <int T, int NP>
auto pick(int split) -> decltype(&launch<T, NP, 8>) {
  return split == T / (kWarps * 8)   ? launch<T, NP, 8>
         : split == T / (kWarps * 4) ? launch<T, NP, 4>
         : split == T / (kWarps * 2) ? launch<T, NP, 2>
                                     : nullptr;
}

template <int NP>
int launch_split(void* F, const void* Ucat, const void* man,
                 const void* rowmap, const void* colmap, const void* run_ptr,
                 int nruns, int R, int RUp, int T, int split, int vec,
                 void* stream) {
  auto* f = T == 128 ? pick<128, NP>(split)
            : T == 256 ? pick<256, NP>(split)
                       : nullptr;
  const bool ok = f != nullptr && nruns >= 0 && R >= 1 && RUp >= T &&
                  RUp % T == 0 && (long long)nruns * split <= INT_MAX &&
                  (reinterpret_cast<uintptr_t>(rowmap) & 15) == 0 &&
                  (vec == 0 || vec == 1) &&
                  (!vec || (R % kVec == 0 &&
                            (reinterpret_cast<uintptr_t>(F) & 15) == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (nruns == 0) return 0;
  return f((float*)F, (const float*)Ucat, (const int*)man, (const int*)rowmap,
           (const int*)colmap, (const int*)run_ptr, nruns, R, RUp, split, vec,
           (cudaStream_t)stream);
}

}  // namespace

extern "C" int sst_extend_add_tiles(void* F, const void* Ucat, const void* man,
                                    const void* rowmap, const void* colmap,
                                    const void* run_ptr, int nruns, int R,
                                    int RUp, int T, int split, int vec,
                                    void* stream) {
  return launch_split<1>(F, Ucat, man, rowmap, colmap, run_ptr, nruns, R, RUp,
                         T, split, vec, stream);
}

extern "C" int sst_extend_add_tiles_pair(void* F, const void* Ucat,
                                         const void* man, const void* rowmap,
                                         const void* colmap,
                                         const void* run_ptr, int nruns,
                                         int R, int RUp, int T, int split,
                                         int vec, void* stream) {
  return launch_split<2>(F, Ucat, man, rowmap, colmap, run_ptr, nruns, R, RUp,
                         T, split, vec, stream);
}
