// Batched Cholesky panel factorization (potrf + trsm, K1) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel suitesparse_tpu/kernels/potrf.py
// (batched_potrf_trsm, body _kernel, pallas_call at :108). For B prepared
// tiles (F11 symmetric with identity on padding, F21 the subdiagonal panel)
// it writes L11 = chol(F11), zero above the diagonal, and L21 = F21 L11^-T.
//
// Same arithmetic as the TPU kernel: a right-looking column loop with an
// rsqrt pivot and no pivoting. The pivot is never clamped: a non-positive
// pivot gives inf/NaN in its tile, which the factor's minor detection
// relies on; no tile reads another's values, so only that tile turns
// non-finite.
//
// What bounds it on the H100. A tile moves (C*C + 2*RU*C) * 4 bytes and
// does C^3/3 + RU*C^2 flops: at the factor's shapes a whole group needs
// 0.2-2 us of bytes. What decides the time is latency: the C dependent
// column steps, each of which needs the column just made, and how much of
// the card takes part (thousands of tiles of C = 8-16, or 40-114 tiles of
// C = 24-48 with RU = 184-384 rows). The design:
// - A tile (or a part of its rows, below) belongs to a team. For C <= 32
//   the team is a segment of 8, 16 or 32 lanes of a warp, so that a warp
//   holds 4, 2 or 1 tiles; for C > 32 it is a block of 2-8 warps.
// - The factor keeps row t of F11 in the registers of thread t (C is a
//   template parameter, 8/16/32/48/64/96, masked to the real C). Step k:
//   the pivot reaches the team by a shuffle within the segment (C <= 32),
//   or, for C > 32, through the unscaled column k in shared memory behind
//   one named barrier of the factor's warps; each thread scales its own
//   entry of column k, and, the column read as 16-byte broadcasts,
//   subtracts l_tk l_jk from its row for every j > k. No block-wide
//   barrier in the step loop.
// - The L21 rows are right-looking too: a thread holds its row in
//   registers; once y_k is scaled, the updates y_j -= y_k l_jk for j > k
//   are independent, so a step has C - k independent FMAs in place of a
//   dependent dot product, fed by the same broadcasts of L's columns.
// - Each tile's RU rows are split into parts, one team each, so that a
//   group of few tiles still fills the card. Every part factors L11 itself
//   (C^3/3 flops, cheap next to its rows) and part 0 writes it: results
//   are the same bits whatever the split, with no atomics and no sum
//   across blocks.
// - A part's F21 rows are one contiguous run. They reach shared memory by
//   16-byte cp.async (4-byte where C % 4 != 0 or a pointer is misaligned),
//   issued before the factor so that the copy flies during the column loop;
//   rows sit at a stride of an odd number of 16-byte words, so that
//   neighbouring lanes read their rows without bank conflicts.
// - For C = 64 and 96 an unrolled step loop costs the compiler tens of
//   seconds, so those instances run a rolled loop (the rows' registers
//   shift by one column a step).
// - The dynamic shared-memory limit is raised once for each instance.
// The launch plan (instance, lanes, warps a team, parts, rows staged at
// once, warps a block, shared memory) is potrf_geometry in
// kernels/potrf.py; the entry point checks it and recomputes its shared
// memory.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxC = 96;
constexpr int kMaxWarps = 8;           // warps of one block
constexpr size_t kMaxSmem = 232448;    // 227 KB, the most a block can take

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Row stride of staged F21 rows: whole 16-byte words, an odd number of
// them (8 lanes on 8 neighbouring rows then meet no bank twice)
__host__ __device__ inline int row_stride(int C) {
  return 4 * ((round4(C) / 4) | 1);
}

// Floats of one team's shared memory: L's columns, kc x kc (row k holds
// column k: scaled for kc <= 32, unscaled for kc = 48, scaled and shifted
// for the rolled instances) | the pivots' rsqrt, round4(kc) | for kc > 48,
// the double-buffered unscaled column, 2 x kc | crow staged F21 rows. Segments (lanes < 32) start `lanes` banks apart, so
// that the segments of a warp writing column k at once meet no bank twice.
__host__ __device__ inline int team_floats(int kc, int lanes, int crow,
                                           int C) {
  int n = kc * kc + round4(kc) + (kc > 48 ? 2 * kc : 0) +
          crow * row_stride(C);
  if (lanes < 32)
    while (n % 32 != lanes) n += 4;
  return n;
}

struct Args {
  int B, C, RU, lanes, split, prow, crow, tf, fw;
  bool vec;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Keeps the compiler from moving shared-memory loads across it: without
// it, the unrolled steps' loads of L's columns are all hoisted to the top
// and the registers run out
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// n rows of C floats from src (contiguous) into dst (row stride ldY), by a
// team's threads (t of nt)
__device__ void stage_rows(float* dst, int ldY, const float* src, int n,
                           int C, bool vec, int t, int nt) {
  if (vec) {
    const int w = C / 4;
    for (int e = t; e < n * w; e += nt) {
      const int r = e / w, q = e - r * w;
      cp_async16(dst + r * ldY + 4 * q, src + (size_t)r * C + 4 * q);
    }
  } else {
    for (int e = t; e < n * C; e += nt) {
      const int r = e / C, c = e - r * C;
      cp_async4(dst + r * ldY + c, src + e);
    }
  }
}

// A row of C floats from device memory (zero past C; all zero unless ok)
template <int kC>
__device__ __forceinline__ void load_row(float (&x)[kC], const float* src,
                                         int C, bool vec, bool ok) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kC / 4; ++q) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok && 4 * q < C) v = __ldg(reinterpret_cast<const float4*>(src) + q);
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z,
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j) x[j] = (ok && j < C) ? __ldg(src + j) : 0.0f;
  }
}

// A staged row of C floats from shared memory (zero past C)
template <int kC>
__device__ __forceinline__ void staged_row(float (&y)[kC], const float* row,
                                           int C, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kC / 4; ++q) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (4 * q < C) v = reinterpret_cast<const float4*>(row)[q];
      y[4 * q] = v.x, y[4 * q + 1] = v.y, y[4 * q + 2] = v.z,
      y[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j) y[j] = j < C ? row[j] : 0.0f;
  }
}

template <int kC>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[kC],
                                          int C, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kC / 4; ++q)
      if (4 * q < C)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (j < C) dst[j] = x[j];
  }
}

// After step k: x[j] -= w * c[j] for j > k, c (row k of the columns) read
// as 16-byte broadcasts
template <int kC>
__device__ __forceinline__ void update(float (&x)[kC], const float* c, int k,
                                       float w) {
#pragma unroll
  for (int q = (k + 1) / 4; q < kC / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(c)[q];
    const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m > k) x[4 * q + m] -= w * l[m];
  }
}

// The factor by a segment of `lanes` lanes (kc <= 32): thread t holds row
// t; the pivot by shuffle, column k scaled into LS. All kc steps run (the
// identity past C leaves the real rows as they are), so all 32 lanes of
// the warp run the same straight-line code.
template <int kC>
__device__ void factor_segment(float (&x)[kC], float* LS, float* rinv, int t,
                               int lanes) {
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const float r = rsqrtf(__shfl_sync(0xffffffffu, x[k], k, lanes));
    const float lk = t >= k ? x[k] * r : 0.0f;
    x[k] = lk;
    if (t < kC) LS[k * kC + t] = lk;
    if (t == k) rinv[k] = r;
    __syncwarp();
    update<kC>(x, LS + k * kC, k, lk);
  }
}

// The factor by the first fw warps of a block (kc = 48): column k,
// unscaled, into UL; one named barrier of those warps a step; l_tk l_jk is
// taken as (l_tk r) UL[k][j]
template <int kC>
__device__ void factor_block(float (&x)[kC], float* UL, float* rinv, int t,
                             int fw) {
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    if (t < kC) UL[k * kC + t] = x[k];
    bar_sync(1, 32 * fw);
    const float r = rsqrtf(UL[k * kC + k]);
    const float lk = t >= k ? x[k] * r : 0.0f;
    x[k] = lk;
    if (t == 0) rinv[k] = r;
    update<kC>(x, UL + k * kC, k, lk * r);
  }
}

// One L21 row: y_j -= y_k l_jk, right-looking (L's columns scaled for
// kc <= 32, unscaled for kc = 48, as the factor left them)
template <int kC>
__device__ __forceinline__ void solve_row(float (&y)[kC], const float* L,
                                          const float* rinv) {
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    fence();
    const float r = rinv[k];
    const float u = y[k] * r;
    y[k] = u;
    update<kC>(y, L + k * kC, k, kC <= 32 ? u : u * r);
  }
}

// The rolled forms (kc = 64, 96). Step k is a runtime loop; a row's
// registers hold its columns k..k+kc-1 (y[0] is column k) and shift by one
// a step. Column k of L is kept shifted too, LS[k][m] = l_(k+m)k, and so is
// the unscaled column U, so that both are read as aligned 16-byte
// broadcasts.
template <int kC>
__device__ __forceinline__ void shift_update(float (&y)[kC], const float* c,
                                             float w) {
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    if (q % 4 == 0) fence();
    const float4 v = reinterpret_cast<const float4*>(c)[q];
    const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m > 0) y[4 * q + m] -= w * l[m];
  }
#pragma unroll
  for (int m = 1; m < kC; ++m) y[m - 1] = y[m];
  y[kC - 1] = 0.0f;
}

template <int kC>
__device__ void factor_rolled(float (&y)[kC], float* LS, float* rinv,
                              float* U, int t, int fw, int C) {
#pragma unroll 1
  for (int k = 0; k < C; ++k) {
    float* Uk = U + (k & 1) * kC;  // two buffers: one barrier a step
    const bool own = t >= k && t < kC;
    if (own) Uk[t - k] = y[0];
    bar_sync(1, 32 * fw);
    const float r = rsqrtf(Uk[0]);
    const float lk = t >= k ? y[0] * r : 0.0f;
    if (own) LS[k * kC + t - k] = lk;
    if (t == 0) rinv[k] = r;
    shift_update<kC>(y, Uk, lk * r);
  }
}

// One F21 row, rolled: column k of the result goes to the staged row
template <int kC>
__device__ __forceinline__ void solve_row_rolled(float (&y)[kC], float* row,
                                                 const float* LS,
                                                 const float* rinv, int C) {
#pragma unroll 1
  for (int k = 0; k < C; ++k) {
    const float u = y[0] * rinv[k];
    row[k] = u;
    shift_update<kC>(y, LS + k * kC, u);
  }
}

// One team a (tile, part): a segment of a.lanes lanes (kC <= 32, several
// a block) or the whole block (kC > 32, its first a.fw warps factor). The
// rolled instances hold a row of 64 or 96 floats and are told that one
// block an SM will do (up to 255 registers; no spills). The unrolled ones
// are given no such count: with one, ptxas defers each step's updates to
// where they are read, keeps every loaded column in registers and spills
// (255 registers at C = 32 and 48); without, they take 42-89 and none.
template <int kC>
__global__ void __launch_bounds__(32 * kMaxWarps, kC > 48 ? 1 : 0)
    potrf_trsm_kernel(const float* __restrict__ f11,
                      const float* __restrict__ f21, float* __restrict__ l11,
                      float* __restrict__ l21, Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kWide = kC > 32;
  constexpr bool kRolled = kC > 48;
  const int lanes = kWide ? (int)blockDim.x : a.lanes;
  const int team = kWide ? 0 : (int)threadIdx.x / lanes;
  const int t = (int)threadIdx.x - team * lanes;
  const int teams = kWide ? 1 : (int)blockDim.x / lanes;
  const long long unit = (long long)blockIdx.x * teams + team;
  const bool live = unit < (long long)a.B * a.split;
  const long long b = live ? unit / a.split : 0;
  const int part = live ? (int)(unit - b * a.split) : 0;
  const int C = a.C;
  const int ldY = row_stride(C);
  float* L = smem + (size_t)team * a.tf;
  float* rinv = L + kC * kC;
  float* U = rinv + round4(kC);
  float* Ys = U + (kRolled ? 2 * kC : 0);
  // the team's lanes, for its barriers (segments of a warp differ in rows)
  const unsigned seg =
      lanes >= 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const auto team_sync = [&] {
    if constexpr (kWide) __syncthreads();
    else __syncwarp(seg);
  };

  const int r0 = part * a.prow;
  const int nrows = live ? max(0, min(a.prow, a.RU - r0)) : 0;
  const float* src21 = nrows ? f21 + ((size_t)b * a.RU + r0) * C : nullptr;
  float* dst21 = nrows ? l21 + ((size_t)b * a.RU + r0) * C : nullptr;
  if (nrows)
    stage_rows(Ys, ldY, src21, min(nrows, a.crow), C, a.vec, t, lanes);

  float x[kC];
  const bool row = live && t < C;
  load_row<kC>(x, f11 + ((size_t)b * C + t) * C, C, a.vec, row);
#pragma unroll
  for (int j = 0; j < kC; ++j)  // identity rows past C and without a tile
    if (!row && j == t) x[j] = 1.0f;
  float* dst11 = l11 + (size_t)b * C * C;
  if constexpr (kRolled) {
    if (t < 32 * a.fw) factor_rolled<kC>(x, L, rinv, U, t, a.fw, C);
    __syncthreads();
    if (part == 0)  // L11 from LS, row by row (LS's column walk is at an
                    // odd stride, kc - 1)
      for (int e = t; e < C * C; e += lanes) {
        const int i = e / C, k = e - i * C;
        dst11[e] = k <= i ? L[k * kC + i - k] : 0.0f;
      }
  } else {
    if constexpr (kWide) {
      if (t < 32 * a.fw) factor_block<kC>(x, L, rinv, t, a.fw);
    } else {
      factor_segment<kC>(x, L, rinv, t, lanes);
    }
    if (live && part == 0 && t < C) {
#pragma unroll
      for (int j = 0; j < kC; ++j)
        if (j > t) x[j] = 0.0f;
      store_row<kC>(dst11 + (size_t)t * C, x, C, a.vec);
    }
  }

  for (int c0 = 0; c0 < nrows; c0 += a.crow) {
    const int n = min(a.crow, nrows - c0);
    if (c0 > 0) {  // every row of the last chunk is done: stage the next
      team_sync();
      stage_rows(Ys, ldY, src21 + (size_t)c0 * C, n, C, a.vec, t, lanes);
    }
    cp_async_wait_all();
    team_sync();
    for (int r = t; r < n; r += lanes) {
      float y[kC];
      float* srow = Ys + r * ldY;
      staged_row<kC>(y, srow, C, a.vec);
      if constexpr (kRolled) {
        solve_row_rolled<kC>(y, srow, L, rinv, C);
      } else {
        solve_row<kC>(y, L, rinv);
        store_row<kC>(dst21 + (size_t)(c0 + r) * C, y, C, a.vec);
      }
    }
    if constexpr (kRolled) {  // the chunk's rows, from the staged rows
      __syncthreads();
      float* dst = dst21 + (size_t)c0 * C;
      if (a.vec) {
        const int w = C / 4;
        for (int e = t; e < n * w; e += lanes) {
          const int r = e / w, q = e - r * w;
          reinterpret_cast<float4*>(dst + (size_t)r * C)[q] =
              reinterpret_cast<const float4*>(Ys + r * ldY)[q];
        }
      } else {
        for (int e = t; e < n * C; e += lanes) {
          const int r = e / C;
          dst[e] = Ys[r * ldY + e - r * C];
        }
      }
    }
  }
}

// The launch plan of potrf_geometry, and the checks of it
struct Plan {
  int inst, lanes, wpt, split, prow, crow, warps, smem;
};

bool plan_ok(int B, int C, int RU, const Plan& p) {
  if (B < 0 || C < 1 || C > kMaxC || RU < 0) return false;
  const int insts[] = {8, 16, 32, 48, 64, 96};
  bool inst_ok = false;
  for (int i : insts) inst_ok |= p.inst == i;
  if (!inst_ok || p.inst < C) return false;
  const bool wide = p.inst > 32;
  const int fw = (p.inst + 31) / 32;
  const bool team_ok =
      wide ? (p.wpt >= fw && p.wpt <= kMaxWarps && p.lanes == 32 * p.wpt &&
              p.warps == p.wpt)
           : (p.wpt == 1 && (p.lanes == 8 || p.lanes == 16 || p.lanes == 32) &&
              p.lanes >= p.inst && p.warps >= 1 && p.warps <= kMaxWarps);
  const bool rows_ok =
      RU == 0 ? (p.split == 1 && p.prow == 0 && p.crow == 0)
              : (p.prow >= 1 && p.split == (RU + p.prow - 1) / p.prow &&
                 p.crow >= 1 && p.crow <= p.prow);
  if (!team_ok || !rows_ok) return false;
  const int teams = wide ? 1 : p.warps * 32 / p.lanes;
  const long long blocks =
      ((long long)B * p.split + teams - 1) / teams;
  return blocks <= 0x7fffffffLL && p.smem >= 0 &&
         (size_t)p.smem <= kMaxSmem &&
         (size_t)p.smem == sizeof(float) * (size_t)teams *
                               team_floats(p.inst, p.lanes, p.crow, C);
}

// cudaFuncSetAttribute once for each instance and device: the limit is
// raised to the card's most, so every plan's shared memory is admitted
template <int kC>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(potrf_trsm_kernel<kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int kC>
int launch(const float* f11, const float* f21, float* l11, float* l21,
           const Args& a, const Plan& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<kC>();
  if (err != cudaSuccess) return (int)err;
  const int teams = kC > 32 ? 1 : p.warps * 32 / p.lanes;
  const long long blocks = ((long long)a.B * p.split + teams - 1) / teams;
  potrf_trsm_kernel<kC><<<(unsigned)blocks, 32 * p.warps, p.smem, stream>>>(
      f11, f21, l11, l21, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sst_potrf_trsm(const void* f11, const void* f21, void* l11,
                              void* l21, int B, int C, int RU, int inst,
                              int lanes, int wpt, int split, int prow,
                              int crow, int warps, int smem, void* stream) {
  const Plan p{inst, lanes, wpt, split, prow, crow, warps, smem};
  if (!plan_ok(B, C, RU, p)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const bool vec = C % 4 == 0 && aligned(f11) && aligned(l11) &&
                   (RU == 0 || (aligned(f21) && aligned(l21)));
  const Args a{B,      C,      RU,
               lanes,  split,  prow,
               crow,   team_floats(inst, lanes, crow, C),
               (inst + 31) / 32,
               vec};
  const auto* F11 = (const float*)f11;
  const auto* F21 = (const float*)f21;
  auto* L11 = (float*)l11;
  auto* L21 = (float*)l21;
  auto s = (cudaStream_t)stream;
  switch (inst) {
    case 8: return launch<8>(F11, F21, L11, L21, a, p, s);
    case 16: return launch<16>(F11, F21, L11, L21, a, p, s);
    case 32: return launch<32>(F11, F21, L11, L21, a, p, s);
    case 48: return launch<48>(F11, F21, L11, L21, a, p, s);
    case 64: return launch<64>(F11, F21, L11, L21, a, p, s);
    default: return launch<96>(F11, F21, L11, L21, a, p, s);
  }
}
