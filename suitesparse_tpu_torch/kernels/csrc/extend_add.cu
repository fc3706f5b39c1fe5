// Extend-add placement of child update blocks (K7) for Hopper (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/extend_add.py
// (extend_add, body _kernel, pallas_call at :110). For parent fronts
// F (B, R, R), child update blocks U, row maps idx (np, RU) (-1 = no row)
// and destination slots dst (np,) sorted ascending:
//
//   F[dst[p], idx[p, i], idx[p, j]] += child_p[i, j]   where both idx >= 0
//
// child_p is U[src[p]] when src is given: the factor passes the source
// group's whole (B_c, RU, RU) update block and each pair reads its child
// where it lies, so no gathered copy is made. Without src, child_p is
// U[p]. F is updated in place (the TPU kernel returned F + the
// contribution). The kernel is templated on the front type TF and the
// update type TU, with four instances: (float, float) and (double, double),
// as the TPU kernel took any dtype, and (float, bfloat16) and (double,
// bfloat16) for a factor that stores its child updates in bfloat16
// (Config.update_dtype). A bfloat16 child is widened to TF on load, which
// is exact, and F is read, added to and written in TF in the same order as
// the same-type instance, so a bfloat16 U gives bit for bit the F that the
// TF instance gives on U widened to TF. One launch places up to kMaxClasses
// pair classes of a group (each with its own U and RU), in their order: the
// factor launches once a group.
//
// What bounds it on the H100: bytes. Each valid child cell is read once and
// added into one parent cell, one add per 12-24 bytes (10-18 with bfloat16
// children). The TPU kernel placed rows, transposed and placed rows again
// through VMEM scratch, one grid step per pair, in order on one core. The
// first port gave each destination slot one block that walked the slot's
// pairs one after another. In the fp64 factor, where no tile manifest
// runs, the tile groups' classes have 1-51 slots, most of them one busy
// slot, and pairs of up to 2624 x 2624 cells: one block on one SM walked
// all of it, and the placement took 321 ms of the factor's 361 ms of
// device time.
//
// Here each slot's R parent rows are cut into bands, one block a (slot,
// band), and each warp of the block owns rows / kWarps neighbouring parent
// rows of the band. The plan lists only the bands that some child row
// reaches, the heaviest first. A warp walks the classes, and each class's
// pairs into its slot, in order; the pairs' row maps hold their valid rows
// first, strictly increasing, then -1, so the child rows that land on the
// warp's parent rows are one contiguous range, found by a warp-wide search
// (32 probes a round, a ballot). The warp takes those child rows one at a
// time, its lanes over the child's valid columns: child loads are vectors
// a lane where RU and the pointers allow, and F's read-modify-writes run
// over increasing parent columns. A cell belongs to one warp, which adds
// its children in class and pair order (a __syncwarp orders the lanes'
// adds of two pairs), so there are no atomics, no block barrier, no shared
// memory, and the bits are those of the one-block-a-slot walk, of one
// launch a class, and of every rerun. A bfloat16 child loads as many
// values a lane as the same-type instance does (four, 8 bytes, for float
// fronts; two, 4 bytes, for double), so that F's accesses keep that
// instance's pattern: eight a lane (16 bytes) gave each lane 8 neighbouring
// F cells, so a warp's access touched twice the sectors, and the (double,
// bfloat16) instance ran 1.47x behind the double one on the fp64 factor's
// largest group (NVIDIA H100 80GB HBM3, 700 W). The grid reaches all SMs
// even where a group has one busy slot; the band height is the plan's
// (kernels/extend_add.py: extend_add_geometry), checked here.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxClasses = 32;

using bf16 = __nv_bfloat16;

// The classes of one launch, passed by value: no copy to the device a call
template <typename TU>
struct Work {
  const TU* U[kMaxClasses];  // class c's child blocks (., RU, RU)
  int ru[kMaxClasses];
  int pair0[kMaxClasses];   // its first pair in dst and src
  int np[kMaxClasses];
  int idx0[kMaxClasses];    // its first map entry in idx
  int vec[kMaxClasses];     // vector child and map loads
};

// The child values a lane loads at once: 16 bytes of TF, and as many
// bfloat16 values (8 or 4 bytes)
template <typename TF> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<double> { static constexpr int n = 2; };

// Two bfloat16 values, the 32-bit word w holds (the lower address in its
// low half), widened exactly to TF by __bfloat1622float2
template <typename TF>
__device__ __forceinline__ void widen2(unsigned w, TF* x) {
  __nv_bfloat162_raw r;
  r.x = (unsigned short)(w & 0xffffu);
  r.y = (unsigned short)(w >> 16);
  const float2 f = __bfloat1622float2(__nv_bfloat162(r));
  x[0] = (TF)f.x;
  x[1] = (TF)f.y;
}

// Vec<TF>::n child values from one load at p (aligned to its size),
// widened to TF into x (x's index is a constant of an unrolled loop, so no
// vector goes through local memory)
template <typename TF, typename TU>
__device__ __forceinline__ void load_child(const TU* p, TF* x) {
  if constexpr (std::is_same_v<TU, float>) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (std::is_same_v<TU, double>) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else if constexpr (std::is_same_v<TF, float>) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    widen2(v.x, x);
    widen2(v.y, x + 2);
  } else {
    widen2(__ldg(reinterpret_cast<const unsigned*>(p)), x);
  }
}

// One child value at p, widened to TF
template <typename TF, typename TU>
__device__ __forceinline__ TF load_one(const TU* p) {
  if constexpr (std::is_same_v<TU, bf16>)
    return (TF)__bfloat162float(__ldg(p));
  else
    return (TF)__ldg(p);
}

// The V map entries at m into c: one 8-byte load for V = 2, one 16-byte
// load for V = 4 (m aligned to match)
template <int V>
__device__ __forceinline__ void load_map(const int* m, int* c) {
  if constexpr (V == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(m));
    c[0] = v.x; c[1] = v.y;
  } else {
    const int4 v = __ldg(reinterpret_cast<const int4*>(m));
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  }
}

// The first position of [lo, hi) where pred turns false (pred holds on a
// prefix), found by the whole warp: 32 probes a round, a ballot, so a map
// of 2624 rows takes 3 rounds
template <typename Pred>
__device__ __forceinline__ int warp_partition(int lo, int hi, int lane,
                                              Pred pred) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + (lane + 1) * step - 1;
    const int n = __popc(__ballot_sync(~0u, q < hi && pred(q)));
    hi = min(hi, lo + (n + 1) * step - 1);
    lo += n * step;
  }
  const int q = lo + lane;
  return lo + __popc(__ballot_sync(~0u, q < hi && pred(q)));
}

// One lane's binary search: the first position of a[0, n) not below v
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Child rows [i0, i1) of one pair, each over its valid columns [0, nv):
// F[m[i], m[j]] += C[i, j]. A lane takes K = 8 cells a step (two vector
// child loads of four, or four of two, and their maps, or eight scalar
// ones), reads their F cells, then adds and stores: the cells of one row
// are distinct, so the loads need not wait for the stores.
template <typename TF, typename TU, bool kVec>
__device__ __forceinline__ void add_rows(TF* __restrict__ Fs, int R,
                                         const TU* __restrict__ C,
                                         const int* __restrict__ m, int ru,
                                         int i0, int i1, int nv, int lane) {
  constexpr int V = kVec ? Vec<TF>::n : 1;
  constexpr int K = 8;
  constexpr int S = K / V;        // column steps of the warp a lane step
  for (int i = i0; i < i1; ++i) {
    TF* Fr = Fs + (size_t)__ldg(m + i) * R;
    const TU* Cr = C + (size_t)i * ru;
    for (int j0 = lane * V; j0 < nv; j0 += 32 * K) {
      TF x[K];
      int c[K];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = j0 + s * 32 * V;
        if constexpr (kVec) {
          if (j < nv) {
            load_child<TF, TU>(Cr + j, x + s * V);
            load_map<V>(m + j, c + s * V);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              x[s * V + k] = TF(0);
              c[s * V + k] = -1;
            }
          }
        } else {
          x[s] = j < nv ? load_one<TF, TU>(Cr + j) : TF(0);
          c[s] = j < nv ? __ldg(m + j) : -1;
        }
      }
      TF f[K];
#pragma unroll
      for (int k = 0; k < K; ++k) f[k] = c[k] >= 0 ? Fr[c[k]] : TF(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c[k] >= 0) Fr[c[k]] = f[k] + x[k];
    }
  }
}

template <typename TF, typename TU>
__global__ void __launch_bounds__(kThreads)
extend_add_kernel(TF* __restrict__ F, const __grid_constant__ Work<TU> w,
                  int ncls, const int* __restrict__ idx,
                  const int* __restrict__ dst, const int* __restrict__ src,
                  const int* __restrict__ blocks, int R, int rows,
                  int nbands) {
  const int b = blocks ? __ldg(blocks + blockIdx.x) : (int)blockIdx.x;
  const int slot = b / nbands;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = rows / kWarps;
  const int r0 = (b - slot * nbands) * rows + warp * h;
  if (r0 >= R) return;  // the whole warp; the kernel has no block barrier
  const int r1 = min(r0 + h, R);
  TF* Fs = F + (size_t)slot * R * R;
  // lane c finds class c's run of pairs into this slot
  int q0 = 0, q1 = 0;
  if (lane < ncls) {
    const int* d = dst + w.pair0[lane];
    q0 = lower_bound(d, w.np[lane], slot);
    q1 = q0 + lower_bound(d + q0, w.np[lane] - q0, slot + 1);
  }
  for (int c = 0; c < ncls; ++c) {
    const int p0 = __shfl_sync(~0u, q0, c);
    const int p1 = __shfl_sync(~0u, q1, c);
    if (p0 == p1) continue;
    const int ru = w.ru[c];
    const int* mc = idx + w.idx0[c];
    const int* sc = src ? src + w.pair0[c] : nullptr;
    const bool vec = w.vec[c];
    for (int p = p0; p < p1; ++p) {
      const int* m = mc + (size_t)p * ru;
      // valid rows first and increasing: the child rows on parent rows
      // [r0, r1) are [i0, i1), and the valid ones [0, nv)
      const int i0 = warp_partition(0, ru, lane, [=](int i) {
        const int v = __ldg(m + i);
        return v >= 0 && v < r0;
      });
      const int i1 = warp_partition(i0, ru, lane, [=](int i) {
        const int v = __ldg(m + i);
        return v >= 0 && v < r1;
      });
      if (i0 == i1) continue;
      const int nv = warp_partition(i1, ru, lane,
                                    [=](int i) { return __ldg(m + i) >= 0; });
      const TU* C = w.U[c] + (size_t)(sc ? __ldg(sc + p) : p) * ru * ru;
      if (vec)
        add_rows<TF, TU, true>(Fs, R, C, m, ru, i0, i1, nv, lane);
      else
        add_rows<TF, TU, false>(Fs, R, C, m, ru, i0, i1, nv, lane);
      __syncwarp();  // this pair's adds land before the next pair's reads
    }
  }
}

template <typename TF, typename TU>
int launch(void* F, const void* const* U, const int* meta, int ncls,
           const void* idx, const void* dst, const void* src,
           const void* blocks, int nblocks, int R, int rows, int nbands,
           cudaStream_t stream) {
  constexpr int V = Vec<TF>::n;
  Work<TU> w = {};
  const bool idx_al = (uintptr_t)idx % 16 == 0;
  for (int c = 0; c < ncls; ++c) {
    const int* mt = meta + 4 * c;
    w.U[c] = (const TU*)U[c];
    w.ru[c] = mt[0];
    w.pair0[c] = mt[1];
    w.np[c] = mt[2];
    w.idx0[c] = mt[3];
    // every child row and its map start on a multiple of their loads
    w.vec[c] = idx_al && mt[0] % V == 0 && mt[3] % V == 0 &&
               (uintptr_t)U[c] % 16 == 0;
  }
  extend_add_kernel<TF, TU><<<nblocks, kThreads, 0, stream>>>(
      (TF*)F, w, ncls, (const int*)idx, (const int*)dst, (const int*)src,
      (const int*)blocks, R, rows, nbands);
  return (int)cudaGetLastError();
}

}  // namespace

// U: a host array of ncls device pointers; meta: a host array of ncls rows
// (RU, first pair, npairs, first idx entry); src may be null (pair p of a
// class reads its U[p]); blocks null: block b is (slot, band) = (b /
// nbands, b % nbands) for all B * nbands of them, else blocks[b] = slot *
// nbands + band; rows and warps from extend_add_geometry; inst the
// instance (F, U): 0 (float, float), 1 (double, double), 2 (float,
// bfloat16), 3 (double, bfloat16)
extern "C" int sst_extend_add(void* F, const void* const* U, const int* meta,
                              int ncls, const void* idx, const void* dst,
                              const void* src, const void* blocks,
                              int nblocks, int B, int R, int rows, int warps,
                              int inst, void* stream) {
  const int h = rows / kWarps;
  if (ncls < 1 || ncls > kMaxClasses || nblocks < 0 || B < 1 || R < 1 ||
      warps != kWarps || rows % kWarps != 0 ||
      (h != 1 && h != 2 && h != 4) || inst < 0 || inst > 3 ||
      !U || !meta || !idx || !dst)
    return (int)cudaErrorInvalidValue;
  const int nbands = (R + rows - 1) / rows;
  if ((long long)B * nbands >= (1LL << 31) ||
      (!blocks && nblocks != B * nbands))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < ncls; ++c) {
    const int* mt = meta + 4 * c;
    if (mt[0] < 1 || mt[1] < 0 || mt[2] < 0 || mt[3] < 0 ||
        (mt[2] > 0 && !U[c]))
      return (int)cudaErrorInvalidValue;
  }
  if (nblocks == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (inst) {
    case 0:
      return launch<float, float>(F, U, meta, ncls, idx, dst, src, blocks,
                                  nblocks, R, rows, nbands, s);
    case 1:
      return launch<double, double>(F, U, meta, ncls, idx, dst, src, blocks,
                                    nblocks, R, rows, nbands, s);
    case 2:
      return launch<float, bf16>(F, U, meta, ncls, idx, dst, src, blocks,
                                 nblocks, R, rows, nbands, s);
    default:
      return launch<double, bf16>(F, U, meta, ncls, idx, dst, src, blocks,
                                  nblocks, R, rows, nbands, s);
  }
}
