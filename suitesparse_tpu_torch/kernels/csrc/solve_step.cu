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
// What bounds it on the H100. A step reads its panel once ((C*C/2 + RU*C)
// * 4 bytes; 305 KB an element at C = 96, RU = 720) for 2*(C*C/2 + RU*C)*NR
// flops: about 0.002 ms of bytes or flops for a whole group at NR 64, far
// below what a launch costs. What decides the time is latency and how much
// of the card takes part: the C dependent steps of the triangular solve,
// the round trip of the panel's loads, and, with one block an element, 12
// of 132 SMs on the widest group. The design:
// - Each element's RU rows are cut into `split` parts of `prow` rows, one
//   block each, so that a group of a few elements still fills the card.
//   Forward, the parts are independent: each block solves xc itself (the C
//   steps are latency, not throughput, and the blocks run side by side)
//   and only part 0 writes it. Backward, the parts are the blocks of a
//   thread-block cluster: each forms the partial sum L21^T xb over its
//   rows, the partial sums meet in the same launch, in rank order, each
//   rank adding up a slice of the cells over all ranks' shared memory
//   (distributed shared memory) into rank 0's, and rank 0 then runs the
//   transposed solve. No memset, no atomics: two calls return the same
//   bits, and one launch a step.
// - The triangular part is K4's warp solve (warp_trisolve.cuh): a warp
//   holds kCPW columns of the right-hand sides in registers, a lane rows
//   l, l + 32, l + 64; no block barrier and no division in the step loop.
//   L11's lower triangle (nothing above it is read) reaches shared memory
//   by 4-byte cp.async at an odd stride.
// - The L21 product is register-tiled and fed from shared memory: a part's
//   L21 rows, with its rows of wb (forward) or of xb and y (backward),
//   arrive by 16-byte cp.async (4-byte copies where C % 4 != 0 or a view
//   is misaligned), all in flight at once, issued before the solve so that
//   the forward's loads fly during its chain of steps. Forward, a thread
//   owns 4 rows of one column or 2 rows of 8 (rows strided by the chunk's
//   row tiles, so that neighbouring threads read neighbouring rows,
//   conflict-free at a row stride of an odd number of 16-byte words) and
//   reuses each L21 word over its columns;
//   backward, a thread owns 4 columns of L21 (one 16-byte word a row) times
//   kCPW right-hand sides of the partial sum. True fp32 FMAs, no tensor
//   cores: the classic sweep's residual gates (1e-5) forbid TF32.
// - Columns of the right-hand sides are taken in slabs of wpt * kCPW (64 at
//   most): warp w of a team solves the slab's chunk w, so NR needs no more
//   shared memory than one slab, and NR 1 and 64 are one slab.
// - Groups of many tiny elements (8735 of C = 8 on the model plan) are
//   bound by the instructions and latency each element costs, not by
//   bytes. A block packs `tpb` teams (elements); for C <= 32 in one part,
//   one slab and one chunk the lean instances drop the loops over parts,
//   slabs and chunks and the cluster code, which lets them keep 3-4 blocks
//   an SM in registers; at NR 1 and RU <= C <= 16 a team is a segment of 8
//   or 16 lanes, so that one warp solves 4 or 2 elements at once (the
//   shuffles of a segment read its own lanes).
// The launch plan (tpb, wpt, lanes, kCPW, chunks, split, prow, crow, shared
// memory) is solve_step_geometry in kernels/solve_step.py; the entry points
// check it and recompute the shared memory it implies.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_trisolve.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxC = 96;
constexpr int kMaxWarps = 8;      // warps of one block
constexpr int kWide = 8;          // columns a warp holds when it holds several
constexpr int kMaxSplit = 16;     // blocks of a cluster (non-portable above 8)
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

// Blocks of 256 threads an SM must hold: 2 (128 registers a thread) in
// general, where several instances spill at 96. The groups of many tiny
// elements (C <= 32) wait on latency and gain from more elements in
// flight (step_sweep on the H100: 14-18% at (8735, 8, 8, 1) from 128 to 80
// registers). They take the lean instances (kLean: one part, one slab,
// one chunk of rows; no loops over them and no cluster), which need fewer
// registers: 3 blocks (80 registers) at 8 columns a warp, 4 (64) at one.
template <int kCPW, bool kLean>
constexpr int min_blocks() {
  return kLean ? (kCPW == 1 ? 4 : 3) : 2;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Row stride of the staged L21 rows: whole 16-byte words, an odd number of
// them (8 neighbouring rows then meet no bank twice)
__host__ __device__ inline int chunk_stride(int C) {
  const int w = round4(C) / 4 + 1;
  return 4 * (w | 1);
}

// columns a slab's rows hold in shared memory: its chunks, whole
__host__ __device__ inline int slab_stride(int NR, int wpt, int cpw) {
  const int chunks = (NR + cpw - 1) / cpw;
  return round4((chunks < wpt ? chunks : wpt) * cpw);
}

// Floats of a block, region by region (each a whole number of 16-byte
// words): every warp's publish rows | every warp's pivot reciprocals | each
// team's L11 (C x ld) | each team's slab of xc (forward) or of the partial
// sum (backward), C x XS | backward: rank 0's y - L21^T xb in a cluster,
// else each team's slab of y, C x XS | each team's staged L21 rows, crow x
// ldp | each team's staged rows of wb (forward) or xb (backward), crow x XS
struct Layout {
  int pub, rinv, ls, xs, xr, lc, xb, total;
  __host__ __device__ Layout(int C, int NR, int tpb, int wpt, int cpw,
                             int split, int crow, bool bwd) {
    const int XS = slab_stride(NR, wpt, cpw);
    pub = 0;
    rinv = pub + tpb * wpt * sst::pub_floats(cpw);
    ls = rinv + round4(tpb * wpt * C);
    xs = ls + round4(tpb * C * sst::odd_stride(C));
    xr = xs + tpb * C * XS;
    lc = xr + (bwd ? (split > 1 ? 1 : tpb) * C * XS : 0);
    xb = lc + tpb * crow * chunk_stride(C);
    total = xb + tpb * crow * XS;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// The lower triangles of the block's nt L11 tiles (diagonal included) into
// Ls at row stride ld, by the whole block's 4-byte asynchronous copies.
__device__ void issue_l11(const float* __restrict__ Lg, float* Ls, int nt,
                          int C, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const size_t CC = (size_t)C * C;
  for (int t = 0; t < nt; ++t)
    for (int i = warp; i < C; i += nw)
      for (int c = lane; c <= i; c += 32)
        sst::cp_async4(Ls + t * C * ld + i * ld + c, Lg + t * CC + i * C + c);
}

// nr rows of `ncol` floats from src (row stride sstride) into dst (row
// stride dstride) by a team's threads (tt of ntt); 16-byte copies when vec
// (ncol, the strides and both bases whole 16-byte words), else 4-byte ones,
// with the columns from ncol up to round4(ncol) set to zero when pad (L21's
// rows, read as 16-byte words; the slabs' rows are read up to their width).
// A thread keeps one word of a row and steps over rows: two divisions a
// call, none a copy.
__device__ void issue_rows(const float* __restrict__ src, size_t sstride,
                           float* dst, int dstride, int nr, int ncol,
                           bool vec, bool pad, int tt, int ntt) {
  const int nw = vec ? ncol / 4 : (pad ? round4(ncol) : ncol);  // words
  if (nw == 0) return;
  const int per = ntt >= nw ? ntt / nw : 1;  // rows a pass
  const int r0 = ntt >= nw ? tt / nw : 0;
  const int q0 = tt - r0 * nw;
  if (r0 >= per) return;  // threads past whole rows
  for (int r = r0; r < nr; r += per)
    for (int q = q0; q < nw; q += ntt) {
      if (vec)
        cp_async16(dst + r * dstride + 4 * q, src + r * sstride + 4 * q);
      else if (q < ncol)
        sst::cp_async4(dst + r * dstride + q, src + r * sstride + q);
      else
        dst[r * dstride + q] = 0.0f;
    }
}

// kCPW columns of row k of a slab (Xs, row stride XS, column offset c):
// zero past `width`, but for the cells of a 16-byte word that `width`
// cuts, which feed only columns that are never stored
template <int kCPW>
__device__ __forceinline__ void slab_row(float (&v)[kCPW], const float* Xs,
                                         int XS, int k, int c, int width) {
  const float* p = Xs + k * XS + c;
  if constexpr (kCPW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kCPW / 4; ++q) {
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c + 4 * q < width) w = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z,
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCPW; ++j) v[j] = c + j < width ? p[j] : 0.0f;
  }
}

// Forward product on one staged chunk of nr rows: v = wb + L21 xc for the
// slab's columns [s0, s0 + width) (nch chunks of kCPW), wb's rows staged in
// Wt. A thread owns rows rt + i nrt (i < kPR: 4 rows of one column, 2 of
// 8, so that its sums, L21 words and xc cells fit in registers) and one
// chunk; it starts from
// wb and adds k in order, 4 at a time (one 16-byte word of each row).
template <int kCPW>
__device__ __forceinline__ void product_fwd(const float* Lt, int ldp, const float* Xt,
                            const float* Wt, int XS, int C, int nr, int nch,
                            int s0, int width, float* __restrict__ Vb, int NR,
                            bool vec, int tt, int ntt) {
  constexpr int kPR = kCPW >= 4 ? 2 : 4;  // rows of v a thread owns
  const int nrt = (nr + kPR - 1) / kPR;
  const int tiles = nrt * nch;
  for (int tile = tt; tile < tiles; tile += ntt) {
    const int rt = tile / nch, ch = tile - rt * nch;
    const int c = ch * kCPW;       // in the slab
    const int cg0 = s0 + c;        // in v
    int row[kPR];
    float acc[kPR][kCPW];
#pragma unroll
    for (int i = 0; i < kPR; ++i) {
      const int r = rt + i * nrt;
      row[i] = r < nr ? r : nr - 1;  // past nr: read row nr - 1, never store
      slab_row<kCPW>(acc[i], Wt, XS, row[i], c, width);
    }
#pragma unroll 1
    for (int k = 0; k < C; k += 4) {  // unrolled, it spilled
      float4 l[kPR];
#pragma unroll
      for (int i = 0; i < kPR; ++i)
        l[i] = *reinterpret_cast<const float4*>(Lt + row[i] * ldp + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float xv[kCPW];
        if (k + kk < C) {
          slab_row<kCPW>(xv, Xt, XS, k + kk, c, width);
        } else {
#pragma unroll
          for (int j = 0; j < kCPW; ++j) xv[j] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kPR; ++i) {
          const float lk = kk == 0 ? l[i].x
                           : kk == 1 ? l[i].y
                           : kk == 2 ? l[i].z
                                     : l[i].w;
#pragma unroll
          for (int j = 0; j < kCPW; ++j) acc[i][j] = fmaf(lk, xv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPR; ++i) {
      if (rt + i * nrt >= nr) continue;
      float* o = Vb + (size_t)row[i] * NR + cg0;
      if constexpr (kCPW % 4 == 0) {
        if (vec) {
#pragma unroll
          for (int q = 0; q < kCPW / 4; ++q)
            if (cg0 + 4 * q < NR)
              *reinterpret_cast<float4*>(o + 4 * q) =
                  make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                              acc[i][4 * q + 2], acc[i][4 * q + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < kCPW; ++j)
        if (cg0 + j < NR) o[j] = acc[i][j];
    }
  }
}

// Backward product on one staged chunk of nr rows: the partial sum Pt
// (C x XS) of L21^T xb for the slab's nch chunks. A thread owns columns
// 4q..4q+3 of L21 and one chunk; it continues Pt's sums (first: from 0)
// over the chunk's rows in order, so a part's sum is one chain over its
// rows, kUnroll rows at a time.
template <int kCPW, int kUnroll>
__device__ void product_bwd(const float* Lt, int ldp, const float* Xbt,
                            int XS, float* Pt, int C, int nr, int nch,
                            int width, bool first, int tt, int ntt) {
  const int nq = (C + 3) / 4;
  const int tiles = nq * nch;
  for (int tile = tt; tile < tiles; tile += ntt) {
    const int ch = tile / nq, q = tile - ch * nq;
    const int c = ch * kCPW;
    float acc[4][kCPW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCPW; ++j)
        acc[i][j] = first || 4 * q + i >= C ? 0.0f
                                             : Pt[(4 * q + i) * XS + c + j];
#pragma unroll kUnroll
    for (int r = 0; r < nr; ++r) {
      const float4 l = *reinterpret_cast<const float4*>(Lt + r * ldp + 4 * q);
      float xv[kCPW];
      slab_row<kCPW>(xv, Xbt, XS, r, c, width);
#pragma unroll
      for (int j = 0; j < kCPW; ++j) {
        acc[0][j] = fmaf(l.x, xv[j], acc[0][j]);
        acc[1][j] = fmaf(l.y, xv[j], acc[1][j]);
        acc[2][j] = fmaf(l.z, xv[j], acc[2][j]);
        acc[3][j] = fmaf(l.w, xv[j], acc[3][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < C)
#pragma unroll
        for (int j = 0; j < kCPW; ++j) Pt[(4 * q + i) * XS + c + j] = acc[i][j];
  }
}

// The warp solve of one column for teams of S <= 32 lanes (a segment of a
// warp, one element each, or the first warp of a team): the lane of row i
// of its team holds x, the segment's first lane is `base`; as
// sst::solve_cells at one row a lane and one column, with each segment's
// own tile St and reciprocals rw, and row k published by a shuffle from
// lane base + k. Every lane of the warp takes part (the shuffles span it).
template <bool kT>
__device__ __forceinline__ float solve_seg(float x, const float* St,
                                           const float* rw, int ld, int C,
                                           int i, int base) {
  const int off = kT ? min(i, C - 1) : min(i, C - 1) * ld;
  const int k0 = kT ? C - 1 : 0;
  float lv = St[off + (kT ? k0 * ld : k0)] * rw[k0];
  for (int n = 0; n < C; ++n) {
    const int k = kT ? C - 1 - n : n;
    const int kq = kT ? max(k - 1, 0) : min(k + 1, C - 1);  // next step
    const float ln = St[off + (kT ? kq * ld : kq)];
    const float rn = rw[kq];
    const float xk = __shfl_sync(0xffffffffu, x, base + k);
    const bool live = kT ? i < k : i > k;
    x = fmaf(-(live ? lv : 0.0f), xk, x);
    lv = ln * rn;
  }
  return x;
}

// Per-launch constants shared by both kernels
struct Args {
  int B, C, RU, NR, tpb, wpt, lanes, chunks, split, prow, crow;
};

// Block blockIdx.x: element block blockIdx.x / split (tpb teams of wpt
// warps, one element each), part blockIdx.x % split (rows [part prow,
// (part + 1) prow) of RU).
template <int kRPL, int kCPW, bool kLean>
__global__ void __launch_bounds__(256, min_blocks<kCPW, kLean>())
solve_step_fwd_kernel(const float* __restrict__ L11,
                      const float* __restrict__ L21, long long l21_bstride,
                      const float* __restrict__ Y,
                      const float* __restrict__ WB, long long wb_bstride,
                      float* __restrict__ XC, float* __restrict__ V, Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kSeg = kLean && kRPL == 1 && kCPW == 1;
  const int C = a.C, NR = a.NR, RU = a.RU, wpt = a.wpt;
  const int ld = sst::odd_stride(C), ldp = chunk_stride(C);
  const int XS = slab_stride(NR, wpt, kCPW);
  const Layout lay(C, NR, a.tpb, wpt, kCPW, a.split, a.crow, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // team t of ntt threads (a.lanes: wpt warps, or a segment of a warp in
  // the lean one-column instance), its thread tt, in its warp w
  const int ntt = a.lanes, t = threadIdx.x / ntt;
  const int tt = threadIdx.x - t * ntt, w = tt >> 5;
  const int part = kLean ? 0 : blockIdx.x % a.split;
  const long long b0 =
      (long long)(kLean ? blockIdx.x : blockIdx.x / a.split) * a.tpb;
  const int nt = (int)min((long long)a.tpb, a.B - b0);
  const bool live = t < nt;
  const long long b = b0 + (live ? t : 0);
  const float* St = smem + lay.ls + t * C * ld;
  float* Xt = smem + lay.xs + t * C * XS;
  float* Lt = smem + lay.lc + t * a.crow * ldp;
  float* Wt = smem + lay.xb + t * a.crow * XS;
  const int j0 = min(RU, part * a.prow), j1 = min(RU, j0 + a.prow);
  const float* Pb = L21 + b * l21_bstride;
  const float* Wbb = WB + b * wb_bstride;
  const bool vecL = C % 4 == 0 && sst::aligned16(L21) && l21_bstride % 4 == 0;
  const bool vecW = NR % 4 == 0 && (RU == 0 || (sst::aligned16(WB) &&
                                                wb_bstride % 4 == 0));
  const bool vec = kCPW % 4 == 0 && NR % 4 == 0 && sst::aligned16(Y) &&
                   sst::aligned16(XC) && (RU == 0 || sst::aligned16(V));
  const bool svec = kCPW % 4 == 0;  // slab rows are whole 16-byte words
  // L11, then the first chunk of L21 and wb rows: in flight during the solve
  issue_l11(L11 + b0 * C * C, smem + lay.ls, nt, C, ld);
  commit();
  const bool resident = kLean || j1 - j0 <= a.crow;  // L21 stays staged
  if (live && j0 < j1) {
    const int nr = min(a.crow, j1 - j0);
    issue_rows(Pb + (size_t)j0 * C, C, Lt, ldp, nr, C, vecL, true, tt, ntt);
    issue_rows(Wbb + (size_t)j0 * NR, NR, Wt, XS, nr,
               min(NR, wpt * kCPW), vecW, false, tt, ntt);
  }
  commit();
  const size_t ybase = (size_t)b * C * NR;
  float* rw = smem + lay.rinv + (t * wpt + w) * C;
  float* buf = smem + lay.pub + warp * sst::pub_floats(kCPW);
  const int slabs = kLean ? 1 : (a.chunks + wpt - 1) / wpt;
  for (int s = 0; s < slabs; ++s) {
    const int ch = s * wpt + w, s0 = s * wpt * kCPW;
    const int width = min(NR - s0, wpt * kCPW);
    if constexpr (kSeg) {  // one slab; warp w solves column w
      const int S = min(ntt, 32), i = tt & 31, base = lane - i;
      float xv = live && ch < a.chunks && i < C
                     ? Y[ybase + (size_t)i * NR + ch] : 0.0f;
      wait_group<1>();  // L11 is in
      __syncthreads();
      if (ch < a.chunks) {  // whole warps
        for (int k = i; k < C; k += S) rw[k] = 1.0f / St[k * ld + k];
        __syncwarp();
        xv = solve_seg<false>(xv, St, rw, ld, C, i, base);
        if (live && i < C) {
          xv *= rw[i];
          XC[ybase + (size_t)i * NR + ch] = xv;
          Xt[i * XS + w] = xv;
        }
      }
    } else {
    float x[kRPL][kCPW];
    if (live && ch < a.chunks)
      sst::load_cells<kRPL, kCPW>(x, Y + ybase + ch * kCPW, C, NR, ch * kCPW,
                                  lane, vec);
    if (s == 0) {
      wait_group<1>();  // L11 is in
      __syncthreads();
      if (live) {
        for (int k = lane; k < C; k += 32) rw[k] = 1.0f / St[k * ld + k];
        __syncwarp();
      }
    } else {
      __syncthreads();  // the previous slab's products are done with Xt
    }
    if (live && ch < a.chunks) {
      const int c0 = ch * kCPW;
      sst::solve_cells<false, kRPL, kCPW>(x, St, rw, ld, C, lane, buf);
      if (part == 0)
        sst::store_cells<kRPL, kCPW>(x, rw, XC + ybase + c0, C, NR, c0, lane,
                                     vec);
      sst::store_cells<kRPL, kCPW>(x, rw, Xt + w * kCPW, C, XS, w * kCPW,
                                   lane, svec);
    }
    }
    if (RU == 0) continue;
    const int nch = min(wpt, a.chunks - s * wpt);
    for (int r0 = j0; r0 < j1; r0 += a.crow) {
      const int nr = min(a.crow, j1 - r0);
      if (!(s == 0 && r0 == j0)) {
        __syncthreads();  // the previous chunk is used up
        if (live) {
          if (!resident)
            issue_rows(Pb + (size_t)r0 * C, C, Lt, ldp, nr, C, vecL, true, tt,
                       ntt);
          issue_rows(Wbb + (size_t)r0 * NR + s0, NR, Wt, XS, nr, width, vecW,
                     false, tt, ntt);
        }
        commit();
      }
      wait_group<0>();
      __syncthreads();  // the chunk and the slab of xc are in
      if (live)
        product_fwd<kCPW>(Lt, ldp, Xt, Wt, XS, C, nr, nch, s0, width,
                          V + ((size_t)b * RU + r0) * NR, NR, vec, tt, ntt);
      if constexpr (kLean) break;  // its one chunk
    }
  }
}

// Block blockIdx.x: element block blockIdx.x / split, rank blockIdx.x %
// split of a cluster of split blocks (tpb = 1 when split > 1).
template <int kRPL, int kCPW, bool kLean>
__global__ void __launch_bounds__(256, min_blocks<kCPW, kLean>())
solve_step_bwd_kernel(const float* __restrict__ L11,
                      const float* __restrict__ L21, long long l21_bstride,
                      const float* __restrict__ Y,
                      const float* __restrict__ XB, long long xb_bstride,
                      float* __restrict__ XC, Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kSeg = kLean && kRPL == 1 && kCPW == 1;
  const int C = a.C, NR = a.NR, RU = a.RU, wpt = a.wpt, split = a.split;
  const int ld = sst::odd_stride(C), ldp = chunk_stride(C);
  const int XS = slab_stride(NR, wpt, kCPW);
  const Layout lay(C, NR, a.tpb, wpt, kCPW, split, a.crow, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // team t of ntt threads (a.lanes: wpt warps, or a segment of a warp in
  // the lean one-column instance), its thread tt, in its warp w
  const int ntt = a.lanes, t = threadIdx.x / ntt;
  const int tt = threadIdx.x - t * ntt, w = tt >> 5;
  const int rank = kLean ? 0 : blockIdx.x % split;
  const long long b0 =
      (long long)(kLean ? blockIdx.x : blockIdx.x / split) * a.tpb;
  const int nt = (int)min((long long)a.tpb, a.B - b0);
  const bool live = t < nt;
  const long long b = b0 + (live ? t : 0);
  const float* St = smem + lay.ls + t * C * ld;
  float* Pt = smem + lay.xs + t * C * XS;
  float* Lt = smem + lay.lc + t * a.crow * ldp;
  float* Xbt = smem + lay.xb + t * a.crow * XS;
  const int j0 = min(RU, rank * a.prow), j1 = min(RU, j0 + a.prow);
  const float* Pb = L21 + b * l21_bstride;
  const float* Xbb = XB + b * xb_bstride;
  const bool vecL = C % 4 == 0 && sst::aligned16(L21) && l21_bstride % 4 == 0;
  const bool vecB = NR % 4 == 0 && (RU == 0 || (sst::aligned16(XB) &&
                                                xb_bstride % 4 == 0));
  const bool vecY = NR % 4 == 0 && sst::aligned16(Y);
  const bool vec = kCPW % 4 == 0 && vecY && sst::aligned16(XC);
  const bool svec = kCPW % 4 == 0;
  float* Yt = smem + lay.xr + t * C * XS;  // split == 1: the slab of y
  if (rank == 0) issue_l11(L11 + b0 * C * C, smem + lay.ls, nt, C, ld);
  commit();
  const bool resident = kLean || j1 - j0 <= a.crow;  // L21 stays staged
  const size_t ybase = (size_t)b * C * NR;
  float* rw = smem + lay.rinv + (t * wpt + w) * C;
  float* buf = smem + lay.pub + warp * sst::pub_floats(kCPW);
  const int slabs = kLean ? 1 : (a.chunks + wpt - 1) / wpt;
  for (int s = 0; s < slabs; ++s) {
    const int s0 = s * wpt * kCPW;
    const int width = min(NR - s0, wpt * kCPW);
    const int nch = min(wpt, a.chunks - s * wpt);
    if (s > 0) __syncthreads();  // the last slab's solve has loaded Pt
    if (RU == 0 && live)
      for (int e = tt; e < C * XS; e += ntt) Pt[e] = 0.0f;
    if (split == 1 && live)  // y's slab, in flight beside the first chunk
      issue_rows(Y + ybase + s0, NR, Yt, XS, C, width, vecY, false, tt, ntt);
    commit();
    for (int r0 = j0; r0 < j1; r0 += a.crow) {
      const int nr = min(a.crow, j1 - r0);
      if (r0 != j0) __syncthreads();  // the last chunk is used up
      if (live) {
        if (s == 0 || !resident)
          issue_rows(Pb + (size_t)r0 * C, C, Lt, ldp, nr, C, vecL, true, tt,
                     ntt);
        issue_rows(Xbb + (size_t)r0 * NR + s0, NR, Xbt, XS, nr, width,
                   vecB, false, tt, ntt);
      }
      commit();
      wait_group<0>();
      __syncthreads();
      if (live)
        // lean: one row at a time, which keeps 8 columns at 80 registers
        product_bwd<kCPW, kLean ? 1 : 2>(Lt, ldp, Xbt, XS, Pt, C, nr, nch,
                                         width, r0 == j0, tt, ntt);
      if constexpr (kLean) break;  // its one chunk
    }
    // y - L21^T xb for the slab, in Xr (rank 0's, in a cluster) or in Pt;
    // the barrier below also makes L11 and y's slab visible where no chunk
    // waited for them
    wait_group<0>();
    const float* Xr = Pt;
    if (!kLean && split > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every rank's partial sum is in its Pt
      float* Xr0 = cluster.map_shared_rank(smem + lay.xr, 0);
      const int cells = C * width;
      const int e0 = rank * cells / split;  // cells * split < 2^31
      const int e1 = (rank + 1) * cells / split;
      for (int e = e0 + (int)threadIdx.x; e < e1; e += blockDim.x) {
        const int k = e / width, c = e - k * width;
        float acc = 0.0f;
        for (int p = 0; p < split; ++p)
          acc += cluster.map_shared_rank(Pt, p)[k * XS + c];
        Xr0[k * XS + c] = Y[ybase + (size_t)k * NR + s0 + c] - acc;
      }
      cluster.sync();  // rank 0's Xr is whole; no rank reads Pt any more
      if (rank != 0) continue;
      Xr = smem + lay.xr;
    } else {
      __syncthreads();  // the team's partial sum is whole
      if (live)
        for (int e = tt; e < C * width; e += ntt) {
          const int k = e / width, c = e - k * width;
          Pt[k * XS + c] = Yt[k * XS + c] - Pt[k * XS + c];
        }
      __syncthreads();
    }
    const int ch = s * wpt + w;
    if constexpr (kSeg) {  // one slab; warp w solves column w
      const int S = min(ntt, 32), i = tt & 31, base = lane - i;
      if (ch < a.chunks) {  // whole warps
        for (int k = i; k < C; k += S) rw[k] = 1.0f / St[k * ld + k];
        __syncwarp();
        float xv = live && i < C ? Xr[i * XS + w] : 0.0f;
        xv = solve_seg<true>(xv, St, rw, ld, C, i, base);
        if (live && i < C) XC[ybase + (size_t)i * NR + ch] = xv * rw[i];
      }
      continue;
    }
    if (s == 0) {
      if (live) {
        for (int k = lane; k < C; k += 32) rw[k] = 1.0f / St[k * ld + k];
        __syncwarp();
      }
    }
    if (live && ch < a.chunks) {
      const int c0 = ch * kCPW;
      float x[kRPL][kCPW];
      sst::load_cells<kRPL, kCPW>(x, Xr + w * kCPW, C, XS, w * kCPW, lane,
                                  svec);
      sst::solve_cells<true, kRPL, kCPW>(x, St, rw, ld, C, lane, buf);
      sst::store_cells<kRPL, kCPW>(x, rw, XC + ybase + c0, C, NR, c0, lane,
                                   vec);
    }
  }
}

// solve_step_geometry's launch plan, and the checks of it
struct Plan {
  int tpb, wpt, lanes, cpw, chunks, split, prow, crow, smem;
};

bool plan_ok(int B, int C, int RU, int NR, bool bwd, const Plan& p) {
  if (B < 0 || C < 1 || C > kMaxC || RU < 0 || NR < 1) return false;
  const bool rows_ok =
      RU == 0 ? (p.split == 1 && p.prow == 0 && p.crow == 0)
              : (p.prow >= 1 && p.split == (RU + p.prow - 1) / p.prow &&
                 p.crow >= 1 && p.crow <= p.prow);
  const int max_split = bwd ? kMaxSplit : 1 << 30;
  // teams of wpt warps, or segments of 8 or 16 lanes of a warp (the lean
  // one-column instance: one row a lane, one part, one chunk, NR 1)
  const bool seg = p.lanes == 8 || p.lanes == 16;
  const bool teams_ok =
      seg ? (p.wpt == 1 && p.cpw == 1 && NR == 1 && C <= p.lanes &&
             p.split == 1 && p.crow >= RU && p.tpb * p.lanes <= 32 * kMaxWarps &&
             p.tpb * p.lanes % 32 == 0)
          : (p.lanes == 32 * p.wpt && p.tpb * p.wpt <= kMaxWarps);
  return rows_ok && teams_ok && p.tpb >= 1 && p.wpt >= 1 &&
         (p.cpw == 1 || p.cpw == kWide) &&
         p.chunks == (NR + p.cpw - 1) / p.cpw && p.split <= max_split &&
         (p.split == 1 || p.tpb == 1) &&
         (long long)(B + p.tpb - 1) / p.tpb * p.split <= 0x7fffffffLL &&
         p.smem >= 0 && (size_t)p.smem <= kMaxSmem &&
         (size_t)p.smem ==
             sizeof(float) * Layout(C, NR, p.tpb, p.wpt, p.cpw, p.split,
                                    p.crow, bwd)
                                 .total;
}

template <typename Kernel, typename... Ts>
int launch(Kernel kernel, const Plan& p, int B, bool cluster,
           cudaStream_t stream, Ts... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster && p.split > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + p.tpb - 1) / p.tpb * p.split));
  cfg.blockDim = dim3(p.tpb * p.lanes);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster && p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kBwd, int kRPL, int kCPW, bool kLean>
int dispatch(const float* L11, const float* L21, long long l21_bstride,
             const float* Y, const float* W, long long w_bstride, float* XC,
             float* V, const Args& a, const Plan& p, cudaStream_t stream) {
  if constexpr (kBwd)
    return launch(solve_step_bwd_kernel<kRPL, kCPW, kLean>, p, a.B, true,
                  stream, L11, L21, l21_bstride, Y, W, w_bstride, XC, a);
  else
    return launch(solve_step_fwd_kernel<kRPL, kCPW, kLean>, p, a.B, false,
                  stream, L11, L21, l21_bstride, Y, W, w_bstride, XC, V, a);
}

// the lean instances (one row a lane): one part, one slab, one chunk
template <bool kBwd, int kRPL, int kCPW>
int dispatch_lean(const float* L11, const float* L21, long long l21_bstride,
                  const float* Y, const float* W, long long w_bstride,
                  float* XC, float* V, const Args& a, const Plan& p,
                  cudaStream_t stream) {
  if constexpr (kRPL == 1) {
    if (p.split == 1 && p.chunks <= p.wpt && p.crow >= a.RU)
      return dispatch<kBwd, kRPL, kCPW, true>(L11, L21, l21_bstride, Y, W,
                                              w_bstride, XC, V, a, p,
                                              stream);
  }
  return dispatch<kBwd, kRPL, kCPW, false>(L11, L21, l21_bstride, Y, W,
                                           w_bstride, XC, V, a, p, stream);
}

template <bool kBwd, int kRPL>
int dispatch_cpw(const float* L11, const float* L21, long long l21_bstride,
                 const float* Y, const float* W, long long w_bstride,
                 float* XC, float* V, const Args& a, const Plan& p,
                 cudaStream_t stream) {
  if (p.cpw == 1)
    return dispatch_lean<kBwd, kRPL, 1>(L11, L21, l21_bstride, Y, W,
                                        w_bstride, XC, V, a, p, stream);
  return dispatch_lean<kBwd, kRPL, kWide>(L11, L21, l21_bstride, Y, W,
                                          w_bstride, XC, V, a, p, stream);
}

template <bool kBwd>
int run(const void* L11, const void* L21, long long l21_bstride,
        const void* Y, const void* W, long long w_bstride, void* XC, void* V,
        int B, int C, int RU, int NR, const Plan& p, void* stream) {
  if (!plan_ok(B, C, RU, NR, kBwd, p)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{B,       C,        RU,      NR,     p.tpb, p.wpt,
               p.lanes, p.chunks, p.split, p.prow, p.crow};
  const auto* l11 = (const float*)L11;
  const auto* l21 = (const float*)L21;
  const auto* y = (const float*)Y;
  const auto* w = (const float*)W;
  auto* xc = (float*)XC;
  auto* v = (float*)V;
  auto s = (cudaStream_t)stream;
  switch ((C + 31) / 32) {
    case 1:
      return dispatch_cpw<kBwd, 1>(l11, l21, l21_bstride, y, w, w_bstride,
                                   xc, v, a, p, s);
    case 2:
      return dispatch_cpw<kBwd, 2>(l11, l21, l21_bstride, y, w, w_bstride,
                                   xc, v, a, p, s);
    default:
      return dispatch_cpw<kBwd, 3>(l11, l21, l21_bstride, y, w, w_bstride,
                                   xc, v, a, p, s);
  }
}

}  // namespace

extern "C" int sst_solve_step_fwd(const void* L11, const void* L21,
                                  long long l21_bstride, const void* Y,
                                  const void* WB, long long wb_bstride,
                                  void* XC, void* V, int B, int C, int RU,
                                  int NR, int tpb, int wpt, int lanes,
                                  int cpw, int chunks, int split, int prow,
                                  int crow, int smem, void* stream) {
  const Plan p{tpb, wpt, lanes, cpw, chunks, split, prow, crow, smem};
  return run<false>(L11, L21, l21_bstride, Y, WB, wb_bstride, XC, V, B, C,
                    RU, NR, p, stream);
}

extern "C" int sst_solve_step_bwd(const void* L11, const void* L21,
                                  long long l21_bstride, const void* Y,
                                  const void* XB, long long xb_bstride,
                                  void* XC, int B, int C, int RU, int NR,
                                  int tpb, int wpt, int lanes, int cpw,
                                  int chunks, int split, int prow, int crow,
                                  int smem, void* stream) {
  const Plan p{tpb, wpt, lanes, cpw, chunks, split, prow, crow, smem};
  return run<true>(L11, L21, l21_bstride, Y, XB, xb_bstride, XC, nullptr, B,
                   C, RU, NR, p, stream);
}
