// Supernodal symbolic analysis: fundamental supernodes, relaxed
// amalgamation, per-supernode row patterns, tree levels.
//
// Equivalent of ``CHOLMOD/Supernodal/cholmod_super_symbolic.c``
// (fundamental supernodes :155-:465, Sparent :465, relaxed amalgamation
// :475-560 with the nrelax/zrelax rule, pattern construction :775+), moved
// from the Python loops in symbolic/supernodes.py to restore the reference's
// analyze:factor time ratio (cholmod_analyze is O(nnz+n)-ish; the Python
// loop was ~68x factor time at n=125k).
//
// Input: LOWER-triangular pattern of the postordered permuted matrix
// (columns hold rows >= j), the column etree and exact column counts.
// The caller has already folded the postorder into the permutation, so
// supernodes are contiguous column ranges and children have smaller ids.
//
// Opaque-handle API (result sizes are data-dependent): analyze -> query
// sizes -> copy arrays -> free.

#include "common.h"
#include <cmath>

namespace {

struct SuperResult {
  i64 nsuper = 0;
  std::vector<i64> super_first;   // nsuper+1
  std::vector<i64> snode_of_col;  // n
  std::vector<i64> sparent;       // nsuper
  std::vector<i64> level_of;      // nsuper
  std::vector<i64> rows_ptr;      // nsuper+1
  std::vector<i64> rows;          // concatenated panel row ids
  std::vector<i64> lpx;           // nsuper+1 flat panel offsets
  double fl = 0.0;
  i64 maxcsize = 0;
};

}  // namespace

SSTPU_API void* sstpu_super_analyze(
    i64 n, const i64* Cp, const i64* Ci, const i64* parent, const i64* cc,
    i64 nrelax0, i64 nrelax1, i64 nrelax2,
    double zrelax0, double zrelax1, double zrelax2) {
  auto* res = new SuperResult();

  // ---- fundamental supernodes (Liu): merge j into j-1's run when j-1's
  // parent is j, col counts chain, and j has exactly one child ----
  std::vector<i64> nchild(n + 1, 0);
  for (i64 j = 0; j < n; j++) nchild[parent[j] >= 0 ? parent[j] : n]++;
  std::vector<i64> sf;
  sf.reserve(n / 4 + 2);
  sf.push_back(0);
  for (i64 j = 1; j < n; j++) {
    bool merge = parent[j - 1] == j && cc[j] == cc[j - 1] - 1 && nchild[j] == 1;
    if (!merge) sf.push_back(j);
  }
  sf.push_back(n);
  i64 ns_f = (i64)sf.size() - 1;

  // ---- relaxed amalgamation (CHOLMOD rule), right-to-left pass ----
  // Track per-block height/zeros/cols exactly; s merges into the block
  // headed by s+1 iff s's parent column lives there and the rule accepts.
  std::vector<i64> block_end(ns_f), height(ns_f), ncols_b(ns_f), zeros_b(ns_f);
  std::vector<char> merged_into_next(ns_f, 0);
  for (i64 s = 0; s < ns_f; s++) {
    block_end[s] = s + 1;
    height[s] = cc[sf[s]];
    ncols_b[s] = sf[s + 1] - sf[s];
    zeros_b[s] = 0;
  }
  for (i64 s = ns_f - 2; s >= 0; s--) {
    i64 parent_col = parent[sf[s + 1] - 1];
    i64 t = s + 1;
    if (parent_col < 0 || parent_col < sf[t] || parent_col >= sf[block_end[t]])
      continue;
    i64 nc_s = ncols_b[s], nc_t = ncols_b[t];
    i64 nstot = nc_s + nc_t;
    i64 H = nc_s + height[t];
    i64 z_add = 0;
    for (i64 i = 0; i < nc_s; i++) z_add += (H - i) - cc[sf[s] + i];
    i64 z_tot = zeros_b[s] + zeros_b[t] + z_add;
    i64 tot = nstot * H - nstot * (nstot - 1) / 2;
    double z = (double)z_tot / (double)std::max<i64>(tot, 1);
    bool ok = nstot <= nrelax0 || z_add == 0 ||
              (nstot <= nrelax1 && z < zrelax0) ||
              (nstot <= nrelax2 && z < zrelax1) || z < zrelax2;
    if (ok) {
      merged_into_next[s] = 1;
      block_end[s] = block_end[t];
      height[s] = H;
      ncols_b[s] = nstot;
      zeros_b[s] = z_tot;
    }
  }
  // heads: leftmost fundamental supernode of each block
  auto& super_first = res->super_first;
  std::vector<i64> head_height;
  super_first.reserve(ns_f + 1);
  for (i64 s = 0; s < ns_f; s++) {
    if (s == 0 || !merged_into_next[s - 1]) {
      super_first.push_back(sf[s]);
      head_height.push_back(height[s]);
    }
  }
  super_first.push_back(n);
  i64 nsuper = (i64)super_first.size() - 1;
  res->nsuper = nsuper;

  // ---- supernode map + etree ----
  auto& scol = res->snode_of_col;
  scol.resize(n);
  for (i64 s = 0; s < nsuper; s++)
    for (i64 j = super_first[s]; j < super_first[s + 1]; j++) scol[j] = s;
  auto& sparent = res->sparent;
  sparent.assign(nsuper, -1);
  for (i64 s = 0; s < nsuper; s++) {
    i64 p = parent[super_first[s + 1] - 1];
    sparent[s] = p >= 0 ? scol[p] : -1;
  }

  // ---- per-supernode row patterns (merge-up; children have smaller ids) --
  // pattern(s) = cols(s) ++ sorted({A-lower rows of cols(s)} ∪
  //                               {child patterns} restricted to >= end(s))
  auto& rows_ptr = res->rows_ptr;
  auto& rows = res->rows;
  rows_ptr.assign(nsuper + 1, 0);
  i64 total = 0;
  for (i64 s = 0; s < nsuper; s++) total += head_height[s];
  rows.reserve(total);
  // child lists
  std::vector<i64> child_head(nsuper, -1), child_next(nsuper, -1);
  for (i64 s = 0; s < nsuper; s++) {
    if (sparent[s] >= 0) {
      child_next[s] = child_head[sparent[s]];
      child_head[sparent[s]] = s;
    }
  }
  std::vector<char> mark(n, 0);
  std::vector<i64> below;
  auto& lpx = res->lpx;
  lpx.assign(nsuper + 1, 0);
  for (i64 s = 0; s < nsuper; s++) {
    i64 f = super_first[s], l = super_first[s + 1];
    rows_ptr[s] = (i64)rows.size();
    for (i64 j = f; j < l; j++) rows.push_back(j);
    below.clear();
    for (i64 j = f; j < l; j++) {
      for (i64 p = Cp[j]; p < Cp[j + 1]; p++) {
        i64 r = Ci[p];
        if (r >= l && !mark[r]) { mark[r] = 1; below.push_back(r); }
      }
    }
    for (i64 c = child_head[s]; c >= 0; c = child_next[c]) {
      // child pattern: own cols first then sorted below rows; binary-search
      // the first entry >= l within the below part
      i64 cb = rows_ptr[c] + (super_first[c + 1] - super_first[c]);
      i64 ce = rows_ptr[c + 1];
      const i64* lo = rows.data() + cb;
      const i64* hi = rows.data() + ce;
      const i64* it = std::lower_bound(lo, hi, l);
      for (; it < hi; ++it) {
        i64 r = *it;
        if (!mark[r]) { mark[r] = 1; below.push_back(r); }
      }
    }
    std::sort(below.begin(), below.end());
    for (i64 r : below) { mark[r] = 0; rows.push_back(r); }
    i64 nr = (l - f) + (i64)below.size();
    i64 nc = l - f;
    lpx[s + 1] = lpx[s] + nr * nc;
    double dnr = (double)nr, dnc = (double)nc;
    res->fl += dnc * dnc * dnc / 3.0 + (dnr - dnc) * dnc * dnc +
               (dnr - dnc) * (dnr - dnc) * dnc;
    res->maxcsize = std::max(res->maxcsize, nr - nc);
  }
  rows_ptr[nsuper] = (i64)rows.size();

  // ---- tree levels ----
  auto& level_of = res->level_of;
  level_of.assign(nsuper, 0);
  for (i64 s = 0; s < nsuper; s++) {
    i64 p = sparent[s];
    if (p >= 0) level_of[p] = std::max(level_of[p], level_of[s] + 1);
  }
  return res;
}

// what: 0 super_first, 1 snode_of_col, 2 sparent, 3 level_of, 4 rows_ptr,
//       5 rows, 6 lpx. Returns length; copies into out when out != null.
SSTPU_API i64 sstpu_super_result(void* h, i64 what, i64* out) {
  auto* res = (SuperResult*)h;
  const std::vector<i64>* v = nullptr;
  switch (what) {
    case 0: v = &res->super_first; break;
    case 1: v = &res->snode_of_col; break;
    case 2: v = &res->sparent; break;
    case 3: v = &res->level_of; break;
    case 4: v = &res->rows_ptr; break;
    case 5: v = &res->rows; break;
    case 6: v = &res->lpx; break;
    default: return -1;
  }
  if (out) std::copy(v->begin(), v->end(), out);
  return (i64)v->size();
}

SSTPU_API double sstpu_super_fl(void* h) { return ((SuperResult*)h)->fl; }
SSTPU_API i64 sstpu_super_maxcsize(void* h) {
  return ((SuperResult*)h)->maxcsize;
}
SSTPU_API void sstpu_super_free(void* h) { delete (SuperResult*)h; }
