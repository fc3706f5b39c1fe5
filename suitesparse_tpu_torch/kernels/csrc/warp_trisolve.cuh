// The warp-held triangular solve of K4 (trisolve.cu), shared with K3
// (solve_step.cu).
//
// A warp owns kCPW columns of one tile's right-hand sides in registers:
// lane l holds rows l, l + 32 and l + 64 (kRPL = ceil(C / 32) of them).
// Step k needs no block barrier: the lane that owns row k publishes its
// cells (a shuffle at kCPW < 4; else 16-byte stores into a double-buffered
// row of the warp's own, a __syncwarp and 16-byte broadcast loads), and
// every lane updates its rows below k (above k, transposed) with one
// shared-memory load of L a row, reused across the warp's columns. The
// loop has no division: each warp holds the pivots' reciprocals in a row
// of shared memory of its own, step k scales the lane's prefetched L
// values by 1 / L[k][k], and each row is scaled by its reciprocal once,
// when it is stored. L is a C x C tile in shared memory at an odd row
// stride (odd_stride), of which only the lower triangle is read.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sst {

// A row stride that is odd (conflict-free column walks in shared memory).
__host__ __device__ inline int odd_stride(int C) { return C + 1 - (C & 1); }

// floats of a warp's publish buffer: two rows of its columns (none when a
// shuffle publishes)
__host__ __device__ inline int pub_floats(int cpw) {
  return cpw >= 4 ? 2 * cpw : 0;
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// xk = the owner lane's cells of row k, in every lane of the warp
template <int kCPW>
__device__ __forceinline__ void publish(const float (&row)[kCPW], int owner,
                                        int lane, float* buf,
                                        float (&xk)[kCPW]) {
  if constexpr (kCPW < 4) {
#pragma unroll
    for (int c = 0; c < kCPW; ++c)
      xk[c] = __shfl_sync(0xffffffffu, row[c], owner);
  } else {
    float4* b4 = reinterpret_cast<float4*>(buf);
    if (lane == owner)
#pragma unroll
      for (int v = 0; v < kCPW / 4; ++v)
        b4[v] = make_float4(row[4 * v], row[4 * v + 1], row[4 * v + 2],
                            row[4 * v + 3]);
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kCPW / 4; ++v) {
      const float4 q = b4[v];
      xk[4 * v] = q.x, xk[4 * v + 1] = q.y;
      xk[4 * v + 2] = q.z, xk[4 * v + 3] = q.w;
    }
  }
}

// One warp solves its cells x (rows lane + 32 j, kCPW columns) against the
// tile St, whose pivots' reciprocals are rw; x is left unscaled (X[k] =
// L[k][k] x_k). buf: the warp's two publish rows. Step k publishes row k
// into buf[k & 1]: the __syncwarp of step k + 1 lies between every lane's
// reads of step k and the write of step k + 2. Each step loads the next
// step's L values and pivot reciprocal before it publishes, so that their
// latency is off the chain of steps; a lane's rows that step k does not
// update take l = 0 (their cells stay as they are while the published
// cells are finite).
template <bool kT, int kRPL, int kCPW>
__device__ __forceinline__ void solve_cells(float (&x)[kRPL][kCPW],
                                            const float* St, const float* rw,
                                            int ld, int C, int lane,
                                            float* buf) {
  int off[kRPL];  // forward: the lane's rows; transposed: its columns. Past
                  // C (never stored) they read row or column C - 1
#pragma unroll
  for (int j = 0; j < kRPL; ++j)
    off[j] = min(lane + 32 * j, C - 1) * (kT ? 1 : ld);
  // this step's multipliers: forward L[i][k] / L[k][k], transposed
  // L[k][i] / L[k][k]
  const int k0 = kT ? C - 1 : 0;
  float lv[kRPL];
#pragma unroll
  for (int j = 0; j < kRPL; ++j)
    lv[j] = St[off[j] + (kT ? k0 * ld : k0)] * rw[k0];
#pragma unroll
  for (int s = 0; s < kRPL; ++s) {
    const int jk = kT ? kRPL - 1 - s : s;  // the slot that holds row k
    const int kn = min(32, C - 32 * jk);
    for (int n = 0; n < kn; ++n) {
      const int kk = kT ? kn - 1 - n : n;
      const int k = 32 * jk + kk;
      const int kq = kT ? max(k - 1, 0) : min(k + 1, C - 1);  // next step
      const int jlo = kT ? 0 : jk, jhi = kT ? jk : kRPL - 1;  // rows it moves
      float ln[kRPL];
#pragma unroll
      for (int j = jlo; j <= jhi; ++j)
        ln[j] = St[off[j] + (kT ? kq * ld : kq)];
      const float rn = rw[kq];
      float xk[kCPW];
      publish<kCPW>(x[jk], kk, lane, buf + (k & 1) * kCPW, xk);
#pragma unroll
      for (int j = jlo; j <= jhi; ++j) {
        const bool live = kT ? (j < jk || lane < kk) : (j > jk || lane > kk);
        const float l = live ? lv[j] : 0.0f;
#pragma unroll
        for (int c = 0; c < kCPW; ++c) x[j][c] = fmaf(-l, xk[c], x[j][c]);
        lv[j] = ln[j] * rn;
      }
    }
  }
}

// x = a chunk's cells of Y (Yc: its first column), zero past C rows or NR
// columns
template <int kRPL, int kCPW>
__device__ __forceinline__ void load_cells(float (&x)[kRPL][kCPW],
                                           const float* __restrict__ Yc,
                                           int C, int NR, int c0, int lane,
                                           bool vec) {
#pragma unroll
  for (int j = 0; j < kRPL; ++j) {
    const int i = lane + 32 * j;
    const float* y = Yc + (size_t)i * NR;
    if constexpr (kCPW % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int v = 0; v < kCPW / 4; ++v) {
          float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (i < C && c0 + 4 * v < NR)
            q = *reinterpret_cast<const float4*>(y + 4 * v);
          x[j][4 * v] = q.x, x[j][4 * v + 1] = q.y;
          x[j][4 * v + 2] = q.z, x[j][4 * v + 3] = q.w;
        }
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < kCPW; ++c)
      x[j][c] = i < C && c0 + c < NR ? y[c] : 0.0f;
  }
}

// X's cells of the chunk = x times the rows' pivot reciprocals rt
template <int kRPL, int kCPW>
__device__ __forceinline__ void store_cells(const float (&x)[kRPL][kCPW],
                                            const float* rt,
                                            float* __restrict__ Xc, int C,
                                            int NR, int c0, int lane,
                                            bool vec) {
#pragma unroll
  for (int j = 0; j < kRPL; ++j) {
    const int i = lane + 32 * j;
    if (i >= C) continue;
    const float r = rt[i];
    float* o = Xc + (size_t)i * NR;
    if constexpr (kCPW % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int v = 0; v < kCPW / 4; ++v)
          if (c0 + 4 * v < NR)
            *reinterpret_cast<float4*>(o + 4 * v) =
                make_float4(x[j][4 * v] * r, x[j][4 * v + 1] * r,
                            x[j][4 * v + 2] * r, x[j][4 * v + 3] * r);
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < kCPW; ++c)
      if (c0 + c < NR) o[c] = x[j][c] * r;
  }
}

}  // namespace sst
