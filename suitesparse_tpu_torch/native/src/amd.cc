// Approximate minimum degree ordering — quotient-graph AMD.
//
// Equivalent of the reference's AMD package (``AMD/Source/amd_2.c:43``,
// pipeline ``amd_order.c`` → ``amd_aat.c`` → ``amd_1.c``). Implemented from the
// published algorithm (P. Amestoy, T. Davis, I. Duff, "An Approximate Minimum
// Degree Ordering Algorithm", SIAM J. Matrix Anal. Appl. 17(4), 1996), with the
// standard machinery: quotient graph of supervariables + elements, two-pass
// approximate external degree update with the w-flag set-difference trick,
// element absorption (including aggressive absorption of fully covered
// elements), supervariable detection by hashing, mass elimination, and
// dense-row postponement. The code is a fresh implementation — data layout,
// state encoding and memory management differ from the reference (std::vector
// pool with live-list compaction instead of the reference's in-place iwlen
// juggling; member chains instead of the pe-tree postprocessing pass).
//
// Input: off-diagonal pattern of A+A' in CSC (Ap[0..n], Ai), symmetric, no
// diagonal, no duplicates. Output: perm[k] = k-th pivot (column of A).

#include "common.h"

namespace {

struct AmdState {
  i64 n;
  std::vector<i64> iw;       // adjacency pool; node lists live at pe[i]
  std::vector<i64> pe;       // list start (offset into iw)
  std::vector<i64> len;      // total list length
  std::vector<i64> elen;     // #elements at list head; -1 live element,
                             // -2 absorbed variable, -3 absorbed element
  std::vector<i64> nv;       // supervariable weight (0 = absorbed)
  std::vector<i64> degree;   // approx external degree (vars) / |Le| (elements)
  std::vector<i64> w;        // wflg workspace
  i64 wflg = 2;

  // degree buckets
  std::vector<i64> dhead, dnext, dlast;
  i64 mindeg = 0;

  // hash buckets for supervariable detection
  std::vector<i64> hhead, hnext;

  // member chains: output members of each principal supervariable
  std::vector<i64> mhead, mtail, mnext;

  i64 pfree = 0;             // next free slot in iw

  bool is_live_var(i64 i) const { return elen[i] >= 0 && nv[i] != 0; }

  void bucket_insert(i64 i, i64 d) {
    dlast[i] = -1;
    dnext[i] = dhead[d];
    if (dhead[d] != -1) dlast[dhead[d]] = i;
    dhead[d] = i;
    if (d < mindeg) mindeg = d;
  }
  void bucket_remove(i64 i, i64 d) {
    if (dlast[i] != -1) dnext[dlast[i]] = dnext[i];
    else if (dhead[d] == i) dhead[d] = dnext[i];
    if (dnext[i] != -1) dlast[dnext[i]] = dlast[i];
    dnext[i] = dlast[i] = -1;
  }

  // Compact the pool: copy every live list to the front, in pe order.
  void garbage_collect() {
    std::vector<std::pair<i64, i64>> live;  // (pe, node)
    live.reserve(n);
    for (i64 i = 0; i < n; i++) {
      if (elen[i] == -2 || elen[i] == -3) continue;  // absorbed
      if (len[i] > 0) live.push_back({pe[i], i});
    }
    std::sort(live.begin(), live.end());
    i64 pw = 0;
    for (auto [ps, node] : live) {
      i64 l = len[node];
      if (pw != ps)
        std::copy(iw.begin() + ps, iw.begin() + ps + l, iw.begin() + pw);
      pe[node] = pw;
      pw += l;
    }
    pfree = pw;
  }

  // ensure `need` free slots at the pool tail
  void reserve_tail(i64 need) {
    if (pfree + need <= (i64)iw.size()) return;
    // try compaction first; grow only if still insufficient
    garbage_collect();
    if (pfree + need > (i64)iw.size()) iw.resize((pfree + need) * 2);
  }
};

}  // namespace

namespace {

// Shared AMD core; cset == nullptr -> unconstrained. With constraints the
// output keeps constraint sets contiguous and in ascending set order
// (reference CAMD semantics: camd.h / camd_2.c — each output supernode stays
// within one constraint set), by restricting pivot selection to the lowest
// still-active set and supervariable/mass merges to same-set variables.
i64 amd_core(i64 n, const i64* Ap, const i64* Ai, i64* perm,
             double dense, i64 aggressive, const i64* cset) {
  if (n <= 0) return 0;
  i64 nnz = Ap[n];
  AmdState S;
  S.n = n;
  S.iw.resize(nnz + nnz / 4 + 2 * n + 16);
  S.pe.assign(n, 0);
  S.len.assign(n, 0);
  S.elen.assign(n, 0);
  S.nv.assign(n, 1);
  S.degree.assign(n, 0);
  S.w.assign(n, 0);
  S.dhead.assign(n + 1, -1);
  S.dnext.assign(n, -1);
  S.dlast.assign(n, -1);
  S.hhead.assign(n + 1, -1);
  S.hnext.assign(n, -1);
  std::vector<i64> hbucket(n, -1);   // hash bucket of each Lme variable
  S.mhead.resize(n);
  S.mtail.resize(n);
  S.mnext.assign(n, -1);
  for (i64 i = 0; i < n; i++) { S.mhead[i] = i; S.mtail[i] = i; }

  // ---- initialization: copy adjacency, postpone dense rows ----
  double sq = 1.0;
  { double t = (double)n; while (sq * sq < t) sq += 1.0; }  // ~sqrt(n)
  i64 dense_cut = (dense <= 0) ? n + 1
                               : std::max<i64>(16, (i64)(dense * sq));
  std::vector<i64> dense_nodes;
  std::vector<char> is_dense(n, 0);
  for (i64 i = 0; i < n; i++) {
    i64 d = Ap[i + 1] - Ap[i];
    if (d >= dense_cut) { is_dense[i] = 1; dense_nodes.push_back(i); }
  }
  // sort dense nodes by original degree (ascending) for the tail of the perm
  std::sort(dense_nodes.begin(), dense_nodes.end(), [&](i64 a, i64 b) {
    i64 da = Ap[a + 1] - Ap[a], db = Ap[b + 1] - Ap[b];
    return da != db ? da < db : a < b;
  });

  i64 pw = 0;
  for (i64 i = 0; i < n; i++) {
    S.pe[i] = pw;
    if (!is_dense[i]) {
      for (i64 p = Ap[i]; p < Ap[i + 1]; p++) {
        i64 j = Ai[p];
        if (j != i && !is_dense[j]) S.iw[pw++] = j;
      }
    }
    S.len[i] = pw - S.pe[i];
    S.degree[i] = S.len[i];
  }
  S.pfree = pw;

  i64 n_sparse = n - (i64)dense_nodes.size();
  for (i64 i = 0; i < n; i++)
    if (!is_dense[i]) S.bucket_insert(i, S.degree[i]);

  std::vector<i64> scratch(n);   // var-list copy during list rewrite
  std::vector<i64> lme;          // pivot element variable list (by node)
  lme.reserve(n);

  i64 nel = 0;     // eliminated original columns (weights)
  i64 nout = 0;    // output cursor

  // constraint bookkeeping: remaining weight per set, current active set
  i64 nsets = 0;
  std::vector<i64> set_remaining;
  if (cset) {
    for (i64 i = 0; i < n; i++) nsets = std::max(nsets, cset[i] + 1);
    set_remaining.assign(nsets, 0);
    for (i64 i = 0; i < n; i++) set_remaining[cset[i]]++;
  }
  i64 cur_set = 0;

  while (nel < n_sparse) {
    // ---- pivot selection: min approximate degree (within the active set) ----
    i64 me = -1;
    if (cset) {
      while (cur_set < nsets && set_remaining[cur_set] == 0) cur_set++;
      // scan degree buckets for the first var in the active set
      for (i64 d = 0; d <= n && me == -1; d++) {
        for (i64 v = S.dhead[d]; v != -1; v = S.dnext[v]) {
          if (cset[v] == cur_set) { me = v; S.bucket_remove(v, d); break; }
        }
      }
    } else {
      while (S.mindeg <= n) {
        me = S.dhead[S.mindeg];
        if (me != -1) break;
        S.mindeg++;
      }
      if (me != -1) S.bucket_remove(me, S.mindeg);
    }
    if (me == -1) return -2;  // should not happen

    i64 nvpiv = S.nv[me];
    nel += nvpiv;

    // ---- construct Lme = (A_me ∪ ∪_e Le) \ {me}, dedup via nv sign flip ----
    S.nv[me] = -nvpiv;
    i64 degme = 0;
    lme.clear();

    i64 p = S.pe[me];
    i64 ne = S.elen[me];
    i64 ln = S.len[me];
    // direct variable neighbors
    for (i64 k = ne; k < ln; k++) {
      i64 j = S.iw[p + k];
      if (S.nv[j] > 0) {
        degme += S.nv[j];
        S.nv[j] = -S.nv[j];
        lme.push_back(j);
        S.bucket_remove(j, S.degree[j]);
      }
    }
    // variables of absorbed elements
    for (i64 k = 0; k < ne; k++) {
      i64 e = S.iw[p + k];
      if (S.elen[e] != -1) continue;  // already absorbed elsewhere
      i64 q = S.pe[e];
      for (i64 t = 0; t < S.len[e]; t++) {
        i64 j = S.iw[q + t];
        if (S.nv[j] > 0) {
          degme += S.nv[j];
          S.nv[j] = -S.nv[j];
          lme.push_back(j);
          S.bucket_remove(j, S.degree[j]);
        }
      }
      S.elen[e] = -3;  // absorbed into me
    }
    // me becomes an element: store Lme as its list
    S.reserve_tail((i64)lme.size());
    S.pe[me] = S.pfree;
    for (i64 j : lme) S.iw[S.pfree++] = j;
    S.len[me] = (i64)lme.size();
    S.elen[me] = -1;
    S.degree[me] = degme;
    // restore nv flags
    for (i64 j : lme) S.nv[j] = -S.nv[j];

    if (lme.empty()) {
      // isolated (super)variable: output directly
      for (i64 m = S.mhead[me]; m != -1; m = S.mnext[m]) {
        perm[nout++] = m;
        if (cset) set_remaining[cset[m]]--;
      }
      S.elen[me] = -3;  // fully retired element
      continue;
    }

    // ---- pass 1: w[e] := |Le \ Lme| + wflg for elements adjacent to Lme ----
    i64 wflg = S.wflg;
    for (i64 j : lme) {
      i64 pj = S.pe[j];
      i64 nej = S.elen[j];
      for (i64 k = 0; k < nej; k++) {
        i64 e = S.iw[pj + k];
        if (S.elen[e] != -1) continue;  // absorbed
        if (S.w[e] < wflg) S.w[e] = S.degree[e] + wflg;
        S.w[e] -= S.nv[j];
      }
    }

    // ---- pass 2: approximate degrees, list compression, hashing ----
    for (i64 j : lme) {
      i64 pj = S.pe[j];
      i64 nej = S.elen[j];
      i64 lnj = S.len[j];
      // copy variable part to scratch (rewrite may overlap)
      i64 nvars = lnj - nej;
      for (i64 k = 0; k < nvars; k++) scratch[k] = S.iw[pj + nej + k];

      i64 deg = 0;
      uint64_t hash = 0;
      i64 pw2 = pj;
      // surviving elements
      for (i64 k = 0; k < nej; k++) {
        i64 e = S.iw[pj + k];
        if (S.elen[e] != -1) continue;           // absorbed
        i64 dext = S.w[e] >= wflg ? S.w[e] - wflg : S.degree[e];
        if (dext > 0) {
          deg += dext;
          S.iw[pw2++] = e;
          hash += (uint64_t)e;
        } else if (aggressive) {
          // aggressive absorption: Le ⊆ Lme ∪ {me}
          S.elen[e] = -3;
        } else {
          S.iw[pw2++] = e;
          hash += (uint64_t)e;
        }
      }
      // me joins the element list
      S.iw[pw2++] = me;
      hash += (uint64_t)me;
      i64 new_ne = pw2 - pj;
      // surviving variables
      for (i64 k = 0; k < nvars; k++) {
        i64 v = scratch[k];
        if (S.nv[v] <= 0) continue;  // absorbed or eliminated (incl. me)
        deg += S.nv[v];
        S.iw[pw2++] = v;
        hash += (uint64_t)v;
      }
      S.elen[j] = new_ne;
      S.len[j] = pw2 - pj;

      deg += degme - S.nv[j];  // |Lme \ j|
      i64 bound = n - nel - S.nv[j];
      deg = std::min(deg, bound);
      deg = std::min(deg, S.degree[j] + degme - S.nv[j]);
      S.degree[j] = std::max<i64>(deg, 0);

      // hash bucket insert for supervariable detection
      i64 hb = (i64)(hash % (uint64_t)n);
      S.hnext[j] = S.hhead[hb];
      S.hhead[hb] = j;
      hbucket[j] = hb;
    }
    S.wflg = wflg + n + 2;

    // ---- supervariable detection within Lme hash buckets ----
    for (i64 j : lme) {
      i64 hb = hbucket[j];
      hbucket[j] = -1;
      if (hb < 0) continue;
      i64 i = S.hhead[hb];
      S.hhead[hb] = -1;  // consume bucket (every Lme var's bucket is visited)
      if (i == -1) continue;
      // pairwise comparison within the bucket
      for (; i != -1; i = S.hnext[i]) {
        if (S.nv[i] <= 0) continue;
        for (i64 k2 = S.hnext[i]; k2 != -1; k2 = S.hnext[k2]) {
          i64 v = k2;
          if (S.nv[v] <= 0) continue;
          if (S.len[v] != S.len[i] || S.elen[v] != S.elen[i]) continue;
          if (cset && cset[v] != cset[i]) continue;  // CAMD: stay in-set
          // compare lists as sets via wflg marking
          i64 mark = S.wflg++;
          i64 pi = S.pe[i];
          for (i64 t = 0; t < S.len[i]; t++) S.w[S.iw[pi + t]] = mark;
          bool same = true;
          i64 pv = S.pe[v];
          for (i64 t = 0; t < S.len[v]; t++)
            if (S.w[S.iw[pv + t]] != mark) { same = false; break; }
          if (same) {
            // absorb v into i
            S.nv[i] += S.nv[v];
            S.nv[v] = 0;
            S.elen[v] = -2;
            S.mnext[S.mtail[i]] = S.mhead[v];
            S.mtail[i] = S.mtail[v];
            S.len[v] = 0;
          }
        }
      }
    }
    // ---- mass elimination + re-bucketing ----
    i64 new_degme = 0;
    for (i64 j : lme) {
      if (S.nv[j] <= 0) continue;
      if (S.degree[j] == 0 && (!cset || cset[j] == cset[me])) {
        // j is internal to me: eliminate with the pivot
        nel += S.nv[j];
        S.nv[j] = 0;
        S.elen[j] = -2;
        S.mnext[S.mtail[me]] = S.mhead[j];
        S.mtail[me] = S.mtail[j];
        continue;
      }
      new_degme += S.nv[j];
      S.bucket_insert(j, S.degree[j]);
    }
    S.degree[me] = new_degme;
    if (new_degme == 0) S.elen[me] = -3;  // element fully retired

    // output the pivot supervariable's members
    for (i64 m = S.mhead[me]; m != -1; m = S.mnext[m]) {
      perm[nout++] = m;
      if (cset) set_remaining[cset[m]]--;
    }
  }

  // postponed dense variables last
  for (i64 i : dense_nodes) perm[nout++] = i;
  return nout == n ? 0 : -1;
}

}  // namespace

SSTPU_API i64 sstpu_amd(i64 n, const i64* Ap, const i64* Ai, i64* perm,
                        double dense, i64 aggressive) {
  return amd_core(n, Ap, Ai, perm, dense, aggressive, nullptr);
}

// Constrained AMD (reference CAMD package: camd.h camd_order / camd_2.c —
// each output supernode stays within one constraint set, sets appear in
// ascending order). Dense postponement is disabled (it would break set
// contiguity).
SSTPU_API i64 sstpu_camd(i64 n, const i64* Ap, const i64* Ai, i64* perm,
                         const i64* cset, i64 aggressive) {
  return amd_core(n, Ap, Ai, perm, 0.0, aggressive, cset);
}
