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
// rate. The w2 sweep's panels are small (a few MB a group), so the time goes
// to latency: bytes in flight on every SM, and short serial chains after
// they land. The design:
//
// - A block owns a contiguous run of panel rows (I axis): several whole
//   panels when the batch is large (epb elements, (8735, 16, 8)), or one
//   part of one panel when it is small. The run is one byte range of M, and
//   (transposed) of X. One thread moves it into shared memory with Hopper's
//   1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx, no tensor map);
//   the block waits on an mbarrier per stage. The run is cut into up to
//   `stages` chunks, all in flight at once where they fit (a longer run
//   cycles through the ring), so that the sums of the first chunk overlap
//   the copies of the next. Shapes whose rows or addresses are not 16-byte
//   aligned (J % 4 != 0, a view at an odd offset) take plain loads into the
//   same buffers, in this kernel.
// - When the batch is small, each panel's rows are split over `split`
//   blocks. Forward, each block owns its rows' outputs, and the split fills
//   the card: (45, 432, 48) runs 270 blocks instead of 45. Transposed, the
//   blocks of one panel form a thread-block cluster: each stores its
//   partial sums into rank 0's shared memory (distributed shared memory),
//   one cluster barrier, and rank 0 adds them in rank order. One launch, no
//   memset, and the same sum on every run; the atomicAdd form K5 uses would
//   add a memset launch to a host-bound sweep and sum in an order that
//   changes from run to run. The cluster's sums cost about half a
//   microsecond, more than smaller copies save on the sweep's panels (one
//   block per 83 KB panel of (45, 432, 48) beat clusters of 2-8 on the
//   H100), so bmv_geometry forms clusters only for panels of several
//   hundred KB.
// - Compute reads shared memory. Transposed: lanes over the J columns
//   (neighbouring words), warps over interleaved row slices, the slices
//   added in shared memory in slice order. Forward: a thread per row (per
//   row and slice of J for rows wider than a block); rows of 32 or more
//   columns sit in shared memory at a padded stride (one bulk copy a row),
//   so that each lane reads 16 bytes of its row without bank conflicts
//   while X is a broadcast. NR is a template parameter, so no
//   instruction is spent on right-hand sides that are not there, and X
//   moves in 16-byte words where NR allows.
//
// The launch geometry (epb, split, part, chunk, stages, xsmem, smem) is
// computed by bmv_geometry in kernels/bmatvec.py; the entry point checks it
// and recomputes the shared memory it implies.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNR = 8;
constexpr int kMaxSplit = 8;    // transposed: a portable cluster
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 64;   // stage barriers + the forward X barrier
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// shared-memory stride of a panel row. Forward rows of 32 or more columns
// (J % 4 == 0) are padded to an odd number of 16-byte words, so that
// neighbouring lanes on neighbouring rows read 16 bytes each without a bank
// conflict; they then arrive by one bulk copy a row.
__host__ __device__ inline int row_stride(bool transpose, int J) {
  if (transpose || J % 4 != 0 || J < 32) return J;
  return J + ((J / 4) % 2 == 0 ? 4 : 8);
}

// floats of one ring stage: a chunk of M rows, then (transposed) its X rows
__host__ __device__ inline int stage_floats(bool transpose, int chunk, int J,
                                            int NR) {
  return round4(chunk * row_stride(transpose, J)) +
         (transpose ? round4(chunk * NR) : 0);
}

// the forward X of a block's elements, when staged
__host__ __device__ inline int xs_floats(bool transpose, int epb, int J,
                                         int NR, int xsmem) {
  return !transpose && xsmem ? round4(epb * J * NR) : 0;
}

// barriers | forward X | ring | slice partial sums (transposed, or forward
// rows wider than a block) | transposed: cluster partial sums
size_t smem_bytes(bool transpose, int J, int NR, int epb, int split,
                  int chunk, int stages, int xsmem) {
  const int tw = J < kThreads ? J : kThreads;
  size_t floats = xs_floats(transpose, epb, J, NR, xsmem) +
                  (size_t)stages * stage_floats(transpose, chunk, J, NR);
  if (transpose || J > kThreads) floats += (size_t)kThreads * NR;
  if (transpose && split > 1) floats += (size_t)split * tw * NR;
  return kBarBytes + sizeof(float) * floats;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ inline void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one thread: copy `n` floats (16-byte aligned, n % 4 == 0) global -> shared
__device__ inline void bulk_copy(float* dst, const float* src, int n,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(n * 4), "r"(smem_addr(bar))
      : "memory");
}

// all threads: the same copy by plain loads (any alignment)
__device__ inline void plain_copy(float* dst, const float* __restrict__ src,
                                  int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v[0:kNR] = p[0:kNR]; p 16-byte aligned where kVec and kNR % 4 == 0
template <int kNR, bool kVec>
__device__ __forceinline__ void load_nr(float (&v)[kNR], const float* p) {
  if constexpr (kVec && kNR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kNR / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z,
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kNR; ++r) v[r] = p[r];
  }
}

// forward: row `row` of a chunk (local row l0 + row, element
// (r0 + l0 + row) / I) over the J slice [k0, k0 + kl) into a[0:kNR]. Padded
// rows (ldm != J) are read 16 bytes at a time, every lane of a warp on the
// same columns, so X is a broadcast; unpadded rows are walked from the
// column row % kl on, which spreads a warp's reads over the banks. xb: the
// run's X (shared or device memory).
template <int kNR, bool kVec>
__device__ __forceinline__ void fwd_row(float (&a)[kNR], const float* st,
                                        const float* __restrict__ xb, int l0,
                                        int row, int r0, int I, int J,
                                        int ldm, int k0, int kl) {
  const float* mrow = st + row * ldm + k0;
  const float* xe = xb + (size_t)((r0 + l0 + row) / I) * J * kNR +
                    (size_t)k0 * kNR;
#pragma unroll
  for (int r = 0; r < kNR; ++r) a[r] = 0.0f;
  if (ldm != J) {  // kl % 4 == 0
    for (int k = 0; k < kl; k += 4) {
      const float4 m4 = *reinterpret_cast<const float4*>(mrow + k);
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
      float x[4 * kNR];  // X rows k .. k + 3, in 16-byte words
      load_nr<4 * kNR, kVec>(x, xe + k * kNR);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < kNR; ++r) a[r] += mv[i] * x[i * kNR + r];
    }
  } else {
    int k = kl > 0 ? row % kl : 0;
    for (int jj = 0; jj < kl; ++jj) {
      const float m = mrow[k];
      float x[kNR];
      load_nr<kNR, kVec>(x, xe + k * kNR);
#pragma unroll
      for (int r = 0; r < kNR; ++r) a[r] += m * x[r];
      k = k + 1 == kl ? 0 : k + 1;
    }
  }
}

// forward, one chunk of `rows` rows. Rows up to a block wide: thread t
// takes rows t, t + 256, ... whole and writes their NR outputs to Z. Wider
// rows, so that no thread walks a whole one: thread (rw, ks) takes row rw
// (rows <= W) over the ks-th of KS slices of J, puts its partial sums in P,
// and the block adds the slices in order.
template <int kNR, bool kVec>
__device__ __forceinline__ void fwd_chunk(const float* st,
                                          const float* __restrict__ xb,
                                          float* P, float* __restrict__ Zc,
                                          int l0, int rows, int r0, int I,
                                          int J, int ldm, int W, int KS,
                                          int klen) {
  float a[kNR];
  if (KS == 1) {
    for (int row = threadIdx.x; row < rows; row += kThreads) {
      fwd_row<kNR, kVec>(a, st, xb, l0, row, r0, I, J, ldm, 0, J);
#pragma unroll
      for (int r = 0; r < kNR; ++r) Zc[row * kNR + r] = a[r];
    }
    return;
  }
  const int rw = threadIdx.x % W, ks = threadIdx.x / W;
  if (ks < KS && rw < rows) {
    const int k0 = ks * klen;
    fwd_row<kNR, kVec>(a, st, xb, l0, rw, r0, I, J, ldm, k0,
                       max(0, min(J - k0, klen)));
#pragma unroll
    for (int r = 0; r < kNR; ++r) P[(ks * W + rw) * kNR + r] = a[r];
  }
  __syncthreads();  // KS is uniform over the block
  for (int e = threadIdx.x; e < rows * kNR; e += kThreads) {
    float v = 0.0f;
    for (int q = 0; q < KS; ++q) v += P[q * W * kNR + e];
    Zc[e] = v;
  }
}

// A block's run of panel rows and how its chunks reach shared memory.
struct Run {
  const float* M;  // the run's first row of M
  const float* X;  // transposed: the run's first row of X
  float* ring;
  uint64_t* bars;
  int nrows, chunk, stages, sfl, J, ldm, mfl, NR;
  bool stage_x;         // transposed: a stage holds its X rows at mfl
  bool bulk_m, bulk_x;  // by bulk copy, else by plain loads
};

// chunk c of the run -> ring stage c % stages; called by every thread
__device__ __forceinline__ void issue(const Run& u, int c) {
  const int t = threadIdx.x;
  float* st = u.ring + (size_t)(c % u.stages) * u.sfl;
  uint64_t* bar = &u.bars[c % u.stages];
  const int rows = min(u.chunk, u.nrows - c * u.chunk);
  const float* Ms = u.M + (size_t)c * u.chunk * u.J;
  const float* Xs = u.X + (size_t)c * u.chunk * u.NR;
  if (u.ldm != u.J) {  // forward, padded rows: warp 0 copies a row per lane
    if (u.bulk_m && t < 32) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (t == 0) mbar_expect(bar, 4u * rows * u.J);
      __syncwarp();
      for (int row = t; row < rows; row += 32)
        bulk_copy(st + row * u.ldm, Ms + (size_t)row * u.J, u.J, bar);
    }
    if (!u.bulk_m)
      for (int e = t; e < rows * u.J; e += kThreads)
        st[e / u.J * u.ldm + e % u.J] = Ms[e];
    return;
  }
  if (t == 0 && (u.bulk_m || u.bulk_x)) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, 4u * ((u.bulk_m ? rows * u.J : 0) +
                           (u.bulk_x ? rows * u.NR : 0)));
    if (u.bulk_m) bulk_copy(st, Ms, rows * u.J, bar);
    if (u.bulk_x) bulk_copy(st + u.mfl, Xs, rows * u.NR, bar);
  }
  if (!u.bulk_m) plain_copy(st, Ms, rows * u.J);
  if (u.stage_x && !u.bulk_x) plain_copy(st + u.mfl, Xs, rows * u.NR);
}

template <bool kTranspose, int kNR>
__global__ void __launch_bounds__(kThreads)
bmatvec_kernel(const float* __restrict__ M, const float* __restrict__ X,
               float* __restrict__ Z, int B, int I, int J, int epb,
               int split, int part, int chunk, int stages, int xsmem) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // stages + 1
  float* XS = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* ring = XS + xs_floats(kTranspose, epb, J, kNR, xsmem);
  const int sfl = stage_floats(kTranspose, chunk, J, kNR);
  float* P = ring + (size_t)stages * sfl;  // kThreads * kNR slice sums
  float* RED = P + kThreads * kNR;         // transposed, split > 1
  const int t = threadIdx.x;
  const int run = blockIdx.x / split, rank = blockIdx.x % split;
  const int b0 = run * epb;
  const int nb = min(epb, B - b0);
  const int r0 = rank * part, r1 = min(I, r0 + part);
  // the block's panel rows, as rows g = b * I + i of M viewed as (B * I, J):
  // [g0, g0 + nrows); local row l = g - g0, element el holds local rows
  // [el * I, el * I + r1 - r0)
  const long long g0 = (long long)b0 * I + r0;
  const int nrows = (nb - 1) * I + (r1 - r0);
  const int nchunks = (nrows + chunk - 1) / chunk;
  const int ldm = row_stride(kTranspose, J);
  const int mfl = round4(chunk * ldm);  // offset of a stage's X rows

  // uniform over the block: which parts move by bulk copy
  const bool bulk_m = aligned16(M) && J % 4 == 0;
  const bool bulk_x = kTranspose && aligned16(X) && (g0 * kNR) % 4 == 0 &&
                      (chunk * kNR) % 4 == 0 && (nrows * kNR) % 4 == 0;
  const float* Xrun = X + (size_t)b0 * J * kNR;  // forward: this run's X
  const int nxf = nb * J * kNR;
  const bool bulk_xf =
      !kTranspose && xsmem && aligned16(Xrun) && nxf % 4 == 0;
  const bool plain_any = !bulk_m || (kTranspose && !bulk_x);

  // transposed, split > 1: the cluster's blocks must all have started
  // before one stores into another's shared memory (waited for below)
  if (kTranspose && split > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (t == 0) {
    for (int i = 0; i <= stages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // no barrier here: thread 0 issues the first copies right away, and no
  // other thread touches an mbarrier before the __syncthreads below

  const Run u{M + g0 * J, kTranspose ? X + g0 * kNR : X, ring, bars,
              nrows, chunk, stages, sfl, J, ldm, mfl, kNR, kTranspose,
              bulk_m, bulk_x};

  if (!kTranspose && xsmem) {
    if (bulk_xf) {
      if (t == 0) {
        mbar_expect(&bars[stages], 4u * nxf);
        bulk_copy(XS, Xrun, nxf, &bars[stages]);
      }
    } else {
      plain_copy(XS, Xrun, nxf);
    }
  }
  for (int c = 0; c < min(stages, nchunks); ++c) issue(u, c);
  __syncthreads();
  if (bulk_xf) mbar_wait(&bars[stages], 0);

  // transposed: thread -> (column tj of this column tile, row slice, element)
  const int TJ = min(J, kThreads);
  const int jt0 = blockIdx.y * TJ;
  const int tw = min(TJ, J - jt0);
  const int s = kTranspose ? kThreads / (epb * TJ) : 1;
  const int tj = t % TJ, slice = (t / TJ) % s, tel = t / TJ / s;
  const bool tlive = kTranspose && tj < tw && tel < nb;
  // forward: W row threads times KS slices of J (slices for wide rows)
  const int W = J > kThreads ? min(chunk, kThreads) : kThreads;
  const int KS = kThreads / W;
  const int klen = ldm != J ? round4((J + KS - 1) / KS) : (J + KS - 1) / KS;
  float acc[kNR];
#pragma unroll
  for (int r = 0; r < kNR; ++r) acc[r] = 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    const float* st = ring + (size_t)(c % stages) * sfl;
    if (bulk_m || bulk_x) mbar_wait(&bars[c % stages], (c / stages) & 1);
    const int l0 = c * chunk, rows = min(chunk, nrows - l0);
    if (kTranspose) {
      if (tlive) {
        const int eb = tel * I;
        const int lo = max(l0, eb), hi = min(l0 + rows, eb + (r1 - r0));
#pragma unroll 8
        for (int l = lo + ((slice - (lo - eb)) % s + s) % s; l < hi; l += s) {
          const int row = l - l0;
          const float m = st[row * ldm + jt0 + tj];
          float x[kNR];
          load_nr<kNR, true>(x, st + mfl + row * kNR);
#pragma unroll
          for (int r = 0; r < kNR; ++r) acc[r] += m * x[r];
        }
      }
    } else {
      float* Zc = Z + (size_t)(g0 + l0) * kNR;
      if (xsmem)
        fwd_chunk<kNR, true>(st, XS, P, Zc, l0, rows, r0, I, J, ldm, W, KS,
                             klen);
      else
        fwd_chunk<kNR, false>(st, Xrun, P, Zc, l0, rows, r0, I, J, ldm, W, KS,
                              klen);
    }
    __syncthreads();  // every thread is done with this stage (and P)
    if (c + stages < nchunks) {
      issue(u, c + stages);
      if (plain_any) __syncthreads();
    }
  }
  if (!kTranspose) return;

  // transposed: slice sums in slice order, then (cluster) in rank order
  if (tlive)
#pragma unroll
    for (int r = 0; r < kNR; ++r)
      P[((tel * s + slice) * TJ + tj) * kNR + r] = acc[r];
  __syncthreads();
  const size_t zbase = ((size_t)b0 * J + jt0) * kNR;
  const int nout = nb * tw * kNR;  // (element, column, NR), as Z holds them
  float* dst = RED;
  if (split > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    dst = cg::this_cluster().map_shared_rank(RED, 0) + rank * nout;
  }
  for (int e = t; e < nout; e += kThreads) {
    const int el = e / (tw * kNR), rem = e % (tw * kNR);
    float v = 0.0f;
    for (int sl = 0; sl < s; ++sl) v += P[(el * s + sl) * TJ * kNR + rem];
    if (split > 1)
      dst[e] = v;
    else
      Z[zbase + e] = v;
  }
  if (split > 1) {
    cg::this_cluster().sync();  // every rank's sums are in rank 0's RED
    if (rank == 0)
      for (int e = t; e < nout; e += kThreads) {
        float v = 0.0f;
        for (int p = 0; p < split; ++p) v += RED[p * nout + e];
        Z[zbase + e] = v;
      }
  }
}

template <bool kTranspose, int kNR>
int launch(const float* M, const float* X, float* Z, int B, int I, int J,
           int epb, int split, int part, int chunk, int stages, int xsmem,
           int smem, cudaStream_t stream) {
  const int TJ = J < kThreads ? J : kThreads;
  const bool ok =
      epb >= 1 && split >= 1 && (!kTranspose || split <= kMaxSplit) &&
      (split == 1 || epb == 1) && part >= 1 &&
      (long long)part * split >= I && (long long)part * (split - 1) < I &&
      (split > 1 || part == I) && chunk >= 1 && stages >= 1 &&
      stages <= kMaxStages && (xsmem == 0 || xsmem == 1) &&
      (!kTranspose || (xsmem == 0 && epb * TJ <= kThreads)) &&
      smem >= 0 && (size_t)smem <= kMaxSmem &&
      (size_t)smem ==
          smem_bytes(kTranspose, J, kNR, epb, split, chunk, stages, xsmem);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = bmatvec_kernel<kTranspose, kNR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + epb - 1) / epb * split,
                     kTranspose ? (J + kThreads - 1) / kThreads : 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kTranspose && split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, M, X, Z, B, I, J, epb, split, part,
                           chunk, stages, xsmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kTranspose>
int launch_nr(int NR, const float* M, const float* X, float* Z, int B, int I,
              int J, int epb, int split, int part, int chunk, int stages,
              int xsmem, int smem, cudaStream_t stream) {
#define SST_BMV_NR(n)                                                       \
  case n:                                                                   \
    return launch<kTranspose, n>(M, X, Z, B, I, J, epb, split, part, chunk, \
                                 stages, xsmem, smem, stream);
  switch (NR) {
    SST_BMV_NR(1)
    SST_BMV_NR(2)
    SST_BMV_NR(3)
    SST_BMV_NR(4)
    SST_BMV_NR(5)
    SST_BMV_NR(6)
    SST_BMV_NR(7)
    SST_BMV_NR(8)
  }
#undef SST_BMV_NR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sst_bmatvec(const void* M, const void* X, void* Z, int B, int I,
                           int J, int NR, int transpose, int epb, int split,
                           int part, int chunk, int stages, int xsmem,
                           int smem, void* stream) {
  if (B < 0 || I < 1 || J < 1 || NR < 1 || NR > kMaxNR)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (transpose)
    return launch_nr<true>(NR, (const float*)M, (const float*)X, (float*)Z,
                           B, I, J, epb, split, part, chunk, stages, xsmem,
                           smem, (cudaStream_t)stream);
  return launch_nr<false>(NR, (const float*)M, (const float*)X, (float*)Z, B,
                          I, J, epb, split, part, chunk, stages, xsmem, smem,
                          (cudaStream_t)stream);
}
