// Symbolic-analysis kernels: elimination tree, postorder, column counts.
//
// Called by symbolic/etree.py (reference analogs:
// cholmod_etree.c:81, cholmod_postorder.c, cholmod_rowcolcounts.c:184,
// cs_etree/cs_post/cs_counts). Implemented from Liu (1986) and
// Gilbert–Ng–Peyton (1994).

#include "common.h"

// etree: if ata_nrow >= 0, computes the column etree of A'A for an
// nrow=ata_nrow CSC input; else the etree of symmetric A (upper triangle used).
SSTPU_API void sstpu_etree(i64 n, const i64* Ap, const i64* Ai, i64* parent,
                           i64 ata_nrow) {
  std::vector<i64> ancestor(n, -1);
  for (i64 j = 0; j < n; j++) parent[j] = -1;
  if (ata_nrow >= 0) {
    std::vector<i64> prev_col(ata_nrow, -1);
    for (i64 k = 0; k < n; k++) {
      for (i64 p = Ap[k]; p < Ap[k + 1]; p++) {
        i64 i = prev_col[Ai[p]];
        while (i != -1 && i < k) {
          i64 nxt = ancestor[i];
          ancestor[i] = k;
          if (nxt == -1) { parent[i] = k; break; }
          i = nxt;
        }
        prev_col[Ai[p]] = k;
      }
    }
  } else {
    for (i64 k = 0; k < n; k++) {
      for (i64 p = Ap[k]; p < Ap[k + 1]; p++) {
        i64 i = Ai[p];
        while (i != -1 && i < k) {
          i64 nxt = ancestor[i];
          ancestor[i] = k;
          if (nxt == -1) { parent[i] = k; break; }
          i = nxt;
        }
      }
    }
  }
}

SSTPU_API void sstpu_postorder(i64 n, const i64* parent, i64* post) {
  std::vector<i64> head(n, -1), next(n, -1), stack(n);
  for (i64 v = n - 1; v >= 0; v--) {
    i64 p = parent[v];
    if (p != -1) { next[v] = head[p]; head[p] = v; }
  }
  i64 k = 0;
  for (i64 root = 0; root < n; root++) {
    if (parent[root] != -1) continue;
    i64 top = 0;
    stack[top] = root;
    while (top >= 0) {
      i64 node = stack[top];
      i64 child = head[node];
      if (child == -1) {
        post[k++] = node;
        top--;
      } else {
        head[node] = next[child];
        stack[++top] = child;
      }
    }
  }
}

namespace {
inline i64 uf_find(std::vector<i64>& up, i64 x) {
  i64 root = x;
  while (up[root] != root) root = up[root];
  while (up[x] != root) { i64 nx = up[x]; up[x] = root; x = nx; }
  return root;
}

inline void process_edge(i64 i, i64 j, const std::vector<i64>& first,
                         std::vector<i64>& maxfirst, std::vector<i64>& prevleaf,
                         std::vector<i64>& up, i64* count) {
  if (i <= j || first[j] <= maxfirst[i]) return;
  maxfirst[i] = first[j];
  i64 jprev = prevleaf[i];
  count[j] += 1;
  if (jprev != -1) count[uf_find(up, jprev)] -= 1;
  prevleaf[i] = j;
}
}  // namespace

// col_counts: counts[j] = nnz(L(:,j)) incl. diagonal, for chol(A) (ata=0,
// input = lower-triangle-by-column CSC, i.e. entries i >= j present; extra
// entries with i < j are ignored) or chol(A'A) (ata=1, input = A in CSC with
// nrow rows).
SSTPU_API void sstpu_col_counts(i64 n, i64 nrow, const i64* Ap, const i64* Ai,
                                const i64* parent, const i64* post, i64* counts,
                                i64 ata) {
  std::vector<i64> first(n, -1), maxfirst(n, -1), prevleaf(n, -1), up(n);
  std::vector<i64> delta(n, 0);
  for (i64 j = 0; j < n; j++) up[j] = j;
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    delta[j] = (first[j] == -1) ? 1 : 0;
    for (i64 t = j; t != -1 && first[t] == -1; t = parent[t]) first[t] = k;
  }

  // ata mode: rows of A bucketed by least postorder position of their columns
  std::vector<i64> head, nextrow, ATp, ATi, ipost;
  if (ata) {
    // build A' (rows of A by row index) via counting sort
    ATp.assign(nrow + 1, 0);
    ATi.resize(Ap[n]);
    for (i64 p = 0; p < Ap[n]; p++) ATp[Ai[p] + 1]++;
    for (i64 i = 0; i < nrow; i++) ATp[i + 1] += ATp[i];
    {
      std::vector<i64> w(ATp.begin(), ATp.end() - 1);
      for (i64 j = 0; j < n; j++)
        for (i64 p = Ap[j]; p < Ap[j + 1]; p++) ATi[w[Ai[p]]++] = j;
    }
    ipost.resize(n);
    for (i64 k = 0; k < n; k++) ipost[post[k]] = k;
    head.assign(n + 1, -1);
    nextrow.assign(nrow, -1);
    for (i64 i = 0; i < nrow; i++) {
      i64 kmin = n;
      for (i64 p = ATp[i]; p < ATp[i + 1]; p++)
        kmin = std::min(kmin, ipost[ATi[p]]);
      nextrow[i] = head[kmin];
      head[kmin] = i;
    }
  }

  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    if (parent[j] != -1) delta[parent[j]] -= 1;
    if (ata) {
      for (i64 i = head[k]; i != -1; i = nextrow[i])
        for (i64 p = ATp[i]; p < ATp[i + 1]; p++)
          process_edge(ATi[p], j, first, maxfirst, prevleaf, up, delta.data());
    } else {
      for (i64 p = Ap[j]; p < Ap[j + 1]; p++)
        process_edge(Ai[p], j, first, maxfirst, prevleaf, up, delta.data());
    }
    if (parent[j] != -1) up[j] = parent[j];
  }
  for (i64 j = 0; j < n; j++) counts[j] = delta[j];
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    if (parent[j] != -1) counts[parent[j]] += counts[j];
  }
}

// Pattern of A + A' minus the diagonal (amd_aat.c analog), DEDUPLICATED:
// output columns are sorted ascending with unique rows regardless of the
// input storage (full or one triangle — A+A' of one stored triangle equals
// A+A' of the full pattern, so no `upper` flag is needed; ADVICE r2 removed
// the ignored parameter). Protocol: first call with outi == nullptr returns
// an UPPER BOUND for allocation; the filling call compacts in place,
// rewrites outp, and returns the actual nnz.
SSTPU_API i64 sstpu_aat(i64 n, const i64* Ap, const i64* Ai,
                        i64* outp, i64* outi) {
  std::vector<i64> cnt(n, 0);
  for (i64 j = 0; j < n; j++)
    for (i64 p = Ap[j]; p < Ap[j + 1]; p++) {
      i64 r = Ai[p];
      if (r == j) continue;
      cnt[j]++;
      cnt[r]++;          // mirrored entry
    }
  i64 nnz = 0;
  for (i64 j = 0; j < n; j++) nnz += cnt[j];
  if (!outi) {
    outp[0] = nnz;
    return nnz;
  }
  outp[0] = 0;
  for (i64 j = 0; j < n; j++) outp[j + 1] = outp[j] + cnt[j];
  std::vector<i64> cur(outp, outp + n);
  for (i64 j = 0; j < n; j++)
    for (i64 p = Ap[j]; p < Ap[j + 1]; p++) {
      i64 r = Ai[p];
      if (r == j) continue;
      outi[cur[j]++] = r;
      outi[cur[r]++] = j;
    }
  // per-column sort + unique, compacting in place (duplicates arise both
  // from full-storage mirroring and repeated entries in jumbled input)
  i64 w = 0;
  i64 prev_end = 0;
  for (i64 j = 0; j < n; j++) {
    i64 lo = prev_end, hi = outp[j + 1];
    prev_end = hi;
    std::sort(outi + lo, outi + hi);
    i64 start = w;
    for (i64 p = lo; p < hi; p++)
      if (p == lo || outi[p] != outi[p - 1]) outi[w++] = outi[p];
    outp[j] = start;
  }
  outp[n] = w;
  // outp[j] currently holds column starts; shift into CSC convention
  // (starts already correct: outp[j] = start of column j, outp[n] = nnz)
  return w;
}

// Symmetric permutation C = P A P' of an UPPER-stored symmetric pattern,
// dtype-agnostic: emits the sorted output pattern plus a position map into
// the input entry array (pos, or ~pos when the entry flipped triangles and
// a Hermitian caller must conjugate it). Two stable counting passes (by row
// then by column) replace sparse.py's O(nnz log nnz) triplet lexsort
// (cs_symperm.c analog, but sorted output).
SSTPU_API void sstpu_symperm(i64 n, const i64* Ap, const i64* Ai,
                             const i64* pinv, i64* outp, i64* outi,
                             i64* outpos) {
  i64 nnz = Ap[n];
  std::vector<i64> r(nnz), c(nnz), pos(nnz);
  {
    i64 k = 0;
    for (i64 j = 0; j < n; j++) {
      i64 j2 = pinv[j];
      for (i64 p = Ap[j]; p < Ap[j + 1]; p++, k++) {
        i64 i2 = pinv[Ai[p]];
        bool flip = i2 > j2;
        r[k] = flip ? j2 : i2;
        c[k] = flip ? i2 : j2;
        pos[k] = flip ? ~p : p;
      }
    }
  }
  // pass 1: stable distribute by row
  std::vector<i64> cnt(n + 1, 0), ord(nnz), ord2(nnz);
  for (i64 k = 0; k < nnz; k++) cnt[r[k] + 1]++;
  for (i64 i = 0; i < n; i++) cnt[i + 1] += cnt[i];
  for (i64 k = 0; k < nnz; k++) ord[cnt[r[k]]++] = k;
  // pass 2: stable distribute by column
  std::fill(cnt.begin(), cnt.end(), 0);
  for (i64 k = 0; k < nnz; k++) cnt[c[k] + 1]++;
  for (i64 i = 0; i < n; i++) cnt[i + 1] += cnt[i];
  for (i64 j = 0; j <= n; j++) outp[j] = cnt[j];
  for (i64 t = 0; t < nnz; t++) {
    i64 k = ord[t];
    ord2[cnt[c[k]]++] = k;
  }
  for (i64 t = 0; t < nnz; t++) {
    outi[t] = r[ord2[t]];
    outpos[t] = pos[ord2[t]];
  }
}

// Transpose pattern + position map, one counting pass, sorted output
// (cs_transpose.c analog; replaces sparse.py's stable argsort).
SSTPU_API void sstpu_transpose(i64 nrow, i64 ncol, const i64* Ap,
                               const i64* Ai, i64* outp, i64* outi,
                               i64* outpos) {
  i64 nnz = Ap[ncol];
  std::vector<i64> cnt(nrow + 1, 0);
  for (i64 p = 0; p < nnz; p++) cnt[Ai[p] + 1]++;
  for (i64 i = 0; i < nrow; i++) cnt[i + 1] += cnt[i];
  for (i64 i = 0; i <= nrow; i++) outp[i] = cnt[i];
  for (i64 j = 0; j < ncol; j++)
    for (i64 p = Ap[j]; p < Ap[j + 1]; p++) {
      i64 q = cnt[Ai[p]]++;
      outi[q] = j;
      outpos[q] = p;
    }
}

// Fused permutation + BTF-block extraction for the KLU-path factor
// (klu_l_factor's in-factor init, done once here as cached position maps;
// numeric/lu.py _prep_perm): two stable counting passes and ONE walk.
//
// Inputs: full-storage pattern (Ap, Ai), row permutation as pinv (new row of
// old row i), column permutation q (new col j <- old col q[j]), BTF block
// boundaries r[0..nblocks].
// Outputs (permuted pattern C = P A Q', columns sorted by row):
//   ip/ii/pos       — C pattern + data position map (C.data = A.data[pos])
//   diag_pos[n]     — PERMUTED position of the diagonal entry of each
//                     1x1 block's column (-1 if absent; n-sized, only
//                     singleton-block columns are set)
//   bo/bip_off      — per-block offsets into the concatenated block arrays
//                     (bo: entries, bip_off: indptr segments; single-column
//                     blocks occupy empty segments)
//   bip/bi/bpos     — concatenated per-block local CSC (indices local to the
//                     block, positions into the PERMUTED data array)
//   oip/oi/opos     — strictly-above-diagonal-block entries as an n-column
//                     CSC (klu Offp/Offi analog), positions into permuted
//                     data
// Entries BELOW the diagonal block are dropped (BTF upper form has none;
// as KLU's). counts = {block nnz total, off nnz}.
SSTPU_API void sstpu_lu_prep(i64 n, const i64* Ap, const i64* Ai,
                             const i64* pinv, const i64* q,
                             const i64* r, i64 nblocks,
                             i64* ip, i64* ii, i64* pos, i64* diag_pos,
                             i64* bo, i64* bip_off,
                             i64* bip, i64* bi, i64* bpos,
                             i64* oip, i64* oi, i64* opos, i64* counts) {
  i64 nnz = Ap[n];
  // two stable counting-sort passes with DIRECT payload movement (no index
  // indirection arrays): by row first (stable in new-column enumeration
  // order, so row buckets are column-sorted), then rows in order
  // redistributed by column -> column-major, rows sorted within columns
  std::vector<i64> rstart(n + 1, 0), fill(n), rcol(nnz), rpos(nnz);
  for (i64 p = 0; p < nnz; p++) rstart[pinv[Ai[p]] + 1]++;
  for (i64 i = 0; i < n; i++) rstart[i + 1] += rstart[i];
  std::copy(rstart.begin(), rstart.end() - 1, fill.begin());
  for (i64 j = 0; j < n; j++) {
    i64 oj = q[j];
    for (i64 p = Ap[oj]; p < Ap[oj + 1]; p++) {
      i64 t = fill[pinv[Ai[p]]]++;
      rcol[t] = j;
      rpos[t] = p;
    }
  }
  std::vector<i64> cnt(n + 1, 0);
  for (i64 t = 0; t < nnz; t++) cnt[rcol[t] + 1]++;
  for (i64 j = 0; j < n; j++) cnt[j + 1] += cnt[j];
  for (i64 j = 0; j <= n; j++) ip[j] = cnt[j];
  std::copy(cnt.begin(), cnt.end() - 1, fill.begin());
  for (i64 i = 0; i < n; i++)
    for (i64 t = rstart[i]; t < rstart[i + 1]; t++) {
      i64 d = fill[rcol[t]]++;
      ii[d] = i;
      pos[d] = rpos[t];
    }
  // block / off / diag walk (one pass over permuted entries)
  std::vector<i64> kb_of(n);
  for (i64 k = 0; k < nblocks; k++)
    for (i64 j = r[k]; j < r[k + 1]; j++) kb_of[j] = k;
  bo[0] = 0;
  bip_off[0] = 0;
  for (i64 k = 0; k < nblocks; k++) {
    i64 nk = r[k + 1] - r[k];
    bip_off[k + 1] = bip_off[k] + (nk > 1 ? nk + 1 : 0);
  }
  i64 bn = 0, on = 0;
  for (i64 j = 0; j < n; j++) diag_pos[j] = -1;
  oip[0] = 0;
  i64 cur_b = -1;
  for (i64 j = 0; j < n; j++) {
    i64 k = kb_of[j];
    i64 k1 = r[k], k2 = r[k + 1];
    bool multi = (k2 - k1) > 1;
    if (multi && k != cur_b) {
      // entering block k: close previous blocks' bo, open indptr segment
      for (i64 kk = cur_b + 1; kk <= k; kk++) bo[kk] = bn;
      bip[bip_off[k]] = 0;
      cur_b = k;
    }
    for (i64 t = ip[j]; t < ip[j + 1]; t++) {
      i64 i = ii[t];
      if (i >= k1 && i < k2) {
        if (multi) {
          bi[bn] = i - k1;
          bpos[bn] = t;
          bn++;
        } else if (i == j) {
          diag_pos[j] = t;
        }
      } else if (i < k1) {
        oi[on] = i;
        opos[on] = t;
        on++;
      }  // i >= k2: dropped (no BTF-lower entries)
    }
    if (multi) bip[bip_off[k] + (j - k1) + 1] = bn - bo[k];
    oip[j + 1] = on;
  }
  for (i64 kk = cur_b + 1; kk <= nblocks; kk++) bo[kk] = bn;
  counts[0] = bn;
  counts[1] = on;
}
