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
// contribution). float and double instances, as the TPU kernel took any
// dtype.
//
// What bounds it on the H100: bytes. Each valid child cell is read once and
// added into one parent cell, one flop per 4-24 bytes. The TPU kernel placed
// rows, transposed and placed rows again through VMEM scratch, one grid
// step per pair; here one block owns one destination slot and walks that
// slot's run of pairs in order (the run is found by binary search in the
// sorted dst, so no host pass is needed). For each pair the block stages the
// row map in shared memory and its threads take consecutive child cells
// (coalesced reads), each adding its cell straight into F; consecutive
// child columns land on increasing parent columns, since the maps are
// sorted. One pair's destinations are distinct and a slot belongs to one
// block, so no atomics are needed: a barrier between pairs orders the adds
// of two pairs that hit the same cell, and two runs give the same bits.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 << 10;  // admitted without an attribute
constexpr size_t kMaxSmem = 232448;        // 227 KB, the most a block can take

__device__ inline int lower_bound(const int* __restrict__ a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
extend_add_kernel(T* __restrict__ F, const T* __restrict__ U,
                  const int* __restrict__ idx, const int* __restrict__ dst,
                  const int* __restrict__ src, int np, int R, int RU) {
  extern __shared__ int map[];  // RU: the pair's row map
  const int slot = blockIdx.x;
  const int t = threadIdx.x;
  const int p0 = lower_bound(dst, np, slot);
  const int p1 = lower_bound(dst, np, slot + 1);
  T* Fs = F + (size_t)slot * R * R;
  const int cells = RU * RU;
  for (int p = p0; p < p1; ++p) {
    __syncthreads();  // the previous pair's adds and map reads are done
    for (int i = t; i < RU; i += kThreads) map[i] = idx[(size_t)p * RU + i];
    __syncthreads();
    const T* Cp = U + (size_t)(src ? src[p] : p) * cells;
    for (int e = t; e < cells; e += kThreads) {
      const int i = e / RU;
      const int r = map[i];
      const int c = map[e - i * RU];
      if (r >= 0 && c >= 0) Fs[(size_t)r * R + c] += Cp[e];
    }
  }
}

// Maps above the default 48 KB (RU > 12288) need the attribute, which is
// set once for each instance and device, to the card's most
template <typename T>
cudaError_t allow_smem(size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(extend_add_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T>
int launch(void* F, const void* U, const void* idx, const void* dst,
           const void* src, int np, int B, int R, int RU,
           cudaStream_t stream) {
  const size_t smem = sizeof(int) * RU;
  const cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  extend_add_kernel<T><<<B, kThreads, smem, stream>>>(
      (T*)F, (const T*)U, (const int*)idx, (const int*)dst, (const int*)src,
      np, R, RU);
  return (int)cudaGetLastError();
}

}  // namespace

// src may be null (pair p reads U[p]); fp64 = 0 for float, 1 for double
extern "C" int sst_extend_add(void* F, const void* U, const void* idx,
                              const void* dst, const void* src, int np, int B,
                              int R, int RU, int fp64, void* stream) {
  if (np < 0 || B < 0 || R < 1 || RU < 0 || (fp64 != 0 && fp64 != 1))
    return (int)cudaErrorInvalidValue;
  if (np == 0 || B == 0 || RU == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return fp64 ? launch<double>(F, U, idx, dst, src, np, B, R, RU, s)
              : launch<float>(F, U, idx, dst, src, np, B, R, RU, s);
}
