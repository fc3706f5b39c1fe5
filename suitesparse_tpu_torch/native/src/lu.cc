// Left-looking sparse LU with threshold partial pivoting, plus the
// same-pattern refactorization fast path.
//
// Host equivalent of the reference KLU numeric kernel
// (``KLU/Source/klu_kernel.c`` Gilbert–Peierls: per-column DFS symbolic +
// sparse lower solve + threshold pivoting with diagonal preference;
// ``klu_refactor.c`` re-factor without pivot search — the circuit-simulation
// fast path) and of the teaching version ``CSparse/Source/cs_lu.c``.
// Implemented from Gilbert & Peierls (1988); fresh code and data layout.
//
// Factor layout (what numeric/lu.py and the host sweeps expect):
//   L: CSC, pivot-space row indices, unit diagonal stored FIRST per column.
//   U: CSC, pivot-space row indices, entries in the DFS topological order the
//      factorization produced, diagonal stored LAST per column (usolve-ready;
//      the stored order doubles as the solve order for refactorization).
//   P: P[k] = original row that is pivot of step k.
//
// Returns 0 ok; -1 = capacity exhausted (caller grows arrays and retries);
// k+1 = structurally or numerically singular at column k.

#include "common.h"
#include <cmath>

SSTPU_API i64 sstpu_lu_factor(i64 n, const i64* Ap, const i64* Ai,
                              const double* Ax, double tol, i64 capacity,
                              i64* Lp, i64* Li, double* Lx,
                              i64* Up, i64* Ui, double* Ux, i64* P) {
  std::vector<i64> pinv(n, -1);        // original row -> pivot step
  std::vector<double> x(n, 0.0);       // dense accumulator (by original row)
  std::vector<char> marked(n, 0);      // DFS mark (by original row)
  std::vector<i64> rstack(n), estack(n), topo(n);
  std::vector<i64> pattern;            // unassigned (L) rows of this column
  pattern.reserve(64);
  // Eisenstat-Liu symmetric pruning (the klu_kernel.c:7 device): once a
  // later pivot row is found in column j AND U(j,k)!=0, the not-yet-pivotal
  // rows of column j are unreachable-first via j (any reach continues
  // through column k instead), so the symbolic DFS may scan only the
  // pivotal prefix. lpend[j] = exclusive end of the pruned scan range,
  // -1 = not pruned (scan the whole column).
  std::vector<i64> lpend(n, -1);

  // During factorization L rows are ORIGINAL row ids (pinv of future pivots
  // unknown); converted to pivot space at the end.
  i64 lnz = 0, unz = 0;
  Lp[0] = 0;
  Up[0] = 0;

  for (i64 k = 0; k < n; k++) {
    // ---- symbolic: reach of A(:,k) over assigned L columns (DFS) ----
    i64 ntopo = 0;        // count of assigned rows, in reverse-topo fill
    pattern.clear();
    for (i64 p = Ap[k]; p < Ap[k + 1]; p++) {
      i64 r = Ai[p];
      if (marked[r]) continue;
      // iterative DFS from r
      i64 top = 0;
      rstack[0] = r;
      while (top >= 0) {
        i64 rr = rstack[top];
        i64 j = pinv[rr];
        if (!marked[rr]) {
          marked[rr] = 1;
          estack[top] = (j >= 0) ? Lp[j] : -1;
        }
        if (j < 0) {               // unassigned row: L candidate, leaf
          pattern.push_back(rr);
          top--;
          continue;
        }
        bool descended = false;
        // skip the unit diagonal (first entry of column j)
        if (estack[top] == Lp[j]) estack[top]++;
        i64 jend = (lpend[j] >= 0) ? lpend[j] : Lp[j + 1];
        while (estack[top] < jend) {
          i64 rnext = Li[estack[top]++];
          if (!marked[rnext]) {
            rstack[++top] = rnext;
            descended = true;
            break;
          }
        }
        if (!descended) {
          topo[ntopo++] = rr;      // all descendants done
          top--;
        }
      }
    }

    // ---- numeric: sparse solve x = L \ A(:,k) ----
    for (i64 p = Ap[k]; p < Ap[k + 1]; p++) x[Ai[p]] = Ax[p];
    // Applying column j = pinv[rr] requires x[rr] final first; in the DFS
    // graph edges run rr -> rows L(:,j) updates, so successors must come
    // after rr. DFS finish order has successors first — apply columns in
    // REVERSE finish order.
    for (i64 t = ntopo - 1; t >= 0; t--) {
      i64 rr = topo[t];
      i64 j = pinv[rr];
      double xj = x[rr];
      if (xj != 0.0) {
        for (i64 p = Lp[j] + 1; p < Lp[j + 1]; p++) x[Li[p]] -= Lx[p] * xj;
      }
    }

    // ---- pivot selection over unassigned rows ----
    double amax = 0.0;
    i64 prow = -1;
    double dval = 0.0;
    bool have_diag = false;
    for (i64 r : pattern) {
      double a = std::fabs(x[r]);
      if (a > amax) { amax = a; prow = r; }
      if (r == k) { have_diag = true; dval = std::fabs(x[r]); }
    }
    if (prow == -1 || amax == 0.0) {
      // cleanup marks/x before reporting singularity
      for (i64 t = 0; t < ntopo; t++) { marked[topo[t]] = 0; x[topo[t]] = 0.0; }
      for (i64 r : pattern) { marked[r] = 0; x[r] = 0.0; }
      return k + 1;
    }
    if (tol > 0.0 && have_diag && dval >= tol * amax) prow = k;  // diag pref

    // ---- capacity check ----
    i64 ladd = (i64)pattern.size();          // incl. pivot (unit diag slot)
    i64 uadd = ntopo + 1;                    // offdiagonals + diagonal
    if (lnz + ladd > capacity || unz + uadd > capacity) {
      for (i64 t = 0; t < ntopo; t++) { marked[topo[t]] = 0; x[topo[t]] = 0.0; }
      for (i64 r : pattern) { marked[r] = 0; x[r] = 0.0; }
      return -1;
    }

    // ---- store U column (topo order = valid solve order), diag last ----
    for (i64 t = ntopo - 1; t >= 0; t--) {
      i64 rr = topo[t];
      Ui[unz] = pinv[rr];
      Ux[unz] = x[rr];
      unz++;
    }
    double pivot = x[prow];
    Ui[unz] = k;
    Ux[unz] = pivot;
    unz++;
    Up[k + 1] = unz;

    // ---- store L column: unit diag first, then scaled off-pivot rows ----
    P[k] = prow;
    pinv[prow] = k;
    Li[lnz] = prow;                // original row id; pivot-space later
    Lx[lnz] = 1.0;
    lnz++;
    for (i64 r : pattern) {
      if (r == prow) continue;
      Li[lnz] = r;
      Lx[lnz] = x[r] / pivot;
      lnz++;
    }
    Lp[k + 1] = lnz;

    // ---- reset workspace ----
    for (i64 t = 0; t < ntopo; t++) { marked[topo[t]] = 0; x[topo[t]] = 0.0; }
    for (i64 r : pattern) { marked[r] = 0; x[r] = 0.0; }

    // ---- Eisenstat-Liu prune: for each U(j,k)!=0 with prow in L(:,j),
    // partition column j so pivotal rows come first; future DFS scans only
    // that prefix. The unit diagonal at Lp[j] is pivotal and stays put.
    for (i64 t = 0; t < ntopo; t++) {
      i64 j = pinv[topo[t]];
      if (lpend[j] >= 0) continue;           // already pruned
      bool found = false;
      for (i64 p = Lp[j] + 1; p < Lp[j + 1]; p++)
        if (Li[p] == prow) { found = true; break; }
      if (!found) continue;
      i64 head = Lp[j] + 1, tail = Lp[j + 1];
      while (head < tail) {
        if (pinv[Li[head]] >= 0) { head++; continue; }
        tail--;
        std::swap(Li[head], Li[tail]);
        std::swap(Lx[head], Lx[tail]);
      }
      lpend[j] = tail;
    }
  }

  // convert L row indices to pivot space
  for (i64 p = 0; p < lnz; p++) Li[p] = pinv[Li[p]];
  return 0;
}

// Refactor with fixed pattern and pivots: recompute Lx/Ux for a matrix with
// the same pattern (klu_refactor analog). L/U/P from a prior sstpu_lu_factor.
// Returns 0 ok, k+1 if a pivot becomes exactly zero.
SSTPU_API i64 sstpu_lu_refactor(i64 n, const i64* Ap, const i64* Ai,
                                const double* Ax,
                                const i64* Lp, const i64* Li, double* Lx,
                                const i64* Up, const i64* Ui, double* Ux,
                                const i64* P) {
  std::vector<i64> pinv(n);
  for (i64 k = 0; k < n; k++) pinv[P[k]] = k;
  std::vector<double> x(n, 0.0);  // accumulator in PIVOT space

  for (i64 k = 0; k < n; k++) {
    for (i64 p = Ap[k]; p < Ap[k + 1]; p++) x[pinv[Ai[p]]] = Ax[p];
    // U column entries are stored in a valid topological solve order
    for (i64 p = Up[k]; p < Up[k + 1] - 1; p++) {
      i64 j = Ui[p];
      double xj = x[j];
      Ux[p] = xj;
      if (xj != 0.0)
        for (i64 q = Lp[j] + 1; q < Lp[j + 1]; q++) x[Li[q]] -= Lx[q] * xj;
    }
    double pivot = x[k];
    Ux[Up[k + 1] - 1] = pivot;
    if (pivot == 0.0) {
      for (i64 p = Lp[k]; p < Lp[k + 1]; p++) x[Li[p]] = 0.0;
      for (i64 p = Up[k]; p < Up[k + 1]; p++) x[Ui[p]] = 0.0;
      return k + 1;
    }
    Lx[Lp[k]] = 1.0;
    for (i64 p = Lp[k] + 1; p < Lp[k + 1]; p++) {
      Lx[p] = x[Li[p]] / pivot;
      x[Li[p]] = 0.0;
    }
    for (i64 p = Up[k]; p < Up[k + 1]; p++) x[Ui[p]] = 0.0;
    x[k] = 0.0;
  }
  return 0;
}
