// Block-triangular-form kernels: maximum transversal + strongly connected
// components.
//
// Host equivalent of the reference BTF package (``BTF/Source/
// btf_maxtrans.c`` augmenting-path matching, ``btf_strongcomp.c`` Tarjan SCC,
// combined by ``btf_order.c:35``). Implemented from the published algorithms
// (Duff 1981 MC21; Tarjan 1972, iterative formulation), own data layout.

#include "common.h"

// Maximum transversal: match[j] = row matched to column j (-1 unmatched).
// Returns the number of matched columns. Depth-first augmenting paths with a
// per-column "cheap" pointer so unmatched-row probing scans each column list
// at most once across the whole run (MC21 style).
//
// work_limit > 0 bounds the augmenting-path work to work_limit * nnz edge
// examinations (the reference btf.h:206 maxwork contract — maxtrans is
// O(n*nnz) worst-case and pathological matrices need the budget). Once the
// budget is spent, remaining columns get only the O(nnz)-total cheap phase,
// so the matching may be suboptimal but the run stays near-linear.
SSTPU_API i64 sstpu_maxtrans(i64 nrow, i64 ncol, const i64* Ap, const i64* Ai,
                             i64* match, double work_limit) {
  std::vector<i64> rowmatch(nrow, -1);   // column matched to each row
  std::vector<i64> cheap(ncol);          // next unscanned entry per column
  std::vector<i64> visited(ncol, -1);    // DFS stamp
  std::vector<i64> cstack(ncol);         // columns on the DFS path
  std::vector<i64> es(ncol);             // per-frame edge cursor
  std::vector<i64> rowused(ncol);        // row used to descend from frame t
  for (i64 j = 0; j < ncol; j++) { match[j] = -1; cheap[j] = Ap[j]; }

  i64 nnz = Ap[ncol];
  i64 budget = work_limit > 0
      ? (i64)std::min(work_limit * (double)std::max<i64>(nnz, 1), 9e18)
      : -1;
  i64 work = 0;

  i64 nmatched = 0;
  for (i64 jroot = 0; jroot < ncol; jroot++) {
    if (match[jroot] != -1) continue;
    i64 top = 0;
    cstack[0] = jroot;
    i64 final_row = -1;
    bool budget_spent = (budget >= 0 && work > budget);
    while (top >= 0 && final_row == -1) {
      i64 j = cstack[top];
      if (visited[j] != jroot) {
        visited[j] = jroot;
        // cheap phase: look for any still-unmatched row in column j
        i64 p = cheap[j];
        for (; p < Ap[j + 1]; p++)
          if (rowmatch[Ai[p]] == -1) break;
        cheap[j] = p;
        if (p < Ap[j + 1]) { final_row = Ai[p]; break; }
        es[top] = Ap[j];
      }
      if (budget_spent) break;  // cheap-only mode: no DFS descent
      // exhaustive phase: steal a row from another column via DFS
      bool descended = false;
      while (es[top] < Ap[j + 1]) {
        work++;
        i64 i = Ai[es[top]++];
        i64 jn = rowmatch[i];
        if (visited[jn] == jroot) continue;
        rowused[top] = i;
        cstack[++top] = jn;
        descended = true;
        break;
      }
      if (!descended) top--;
    }
    if (final_row != -1) {
      // augment: the deepest column takes the fresh row; every column above
      // takes the row it descended through
      i64 j = cstack[top];
      match[j] = final_row;
      rowmatch[final_row] = j;
      for (i64 t = top - 1; t >= 0; t--) {
        match[cstack[t]] = rowused[t];
        rowmatch[rowused[t]] = cstack[t];
      }
      nmatched++;
    }
  }
  return nmatched;
}

// Tarjan strongly connected components (iterative).
// Input: square digraph in CSC; edge j -> Ai[p] (column j "points at" its row
// indices). Output: p = permutation grouping SCCs so that A(p,p) is block
// UPPER triangular (btf_strongcomp convention), r[0..nb] = block boundaries
// in p. Returns nb. Tarjan pops sink components first; a sink component's
// columns have entries only within the component, which is exactly the
// top-left block — so pop order IS the output block order.
SSTPU_API i64 sstpu_strongcomp(i64 n, const i64* Ap, const i64* Ai,
                               i64* p, i64* r) {
  std::vector<i64> low(n, -1), num(n, -1), sccid(n, -1);
  std::vector<i64> dstack(n), estack(n);
  std::vector<i64> tstack;
  std::vector<char> onstack(n, 0);
  tstack.reserve(n);
  i64 counter = 0, nscc = 0;

  for (i64 root = 0; root < n; root++) {
    if (num[root] != -1) continue;
    i64 top = 0;
    dstack[0] = root;
    estack[0] = Ap[root];
    num[root] = low[root] = counter++;
    tstack.push_back(root);
    onstack[root] = 1;
    while (top >= 0) {
      i64 v = dstack[top];
      if (estack[top] < Ap[v + 1]) {
        i64 w = Ai[estack[top]++];
        if (num[w] == -1) {
          num[w] = low[w] = counter++;
          tstack.push_back(w);
          onstack[w] = 1;
          dstack[++top] = w;
          estack[top] = Ap[w];
        } else if (onstack[w]) {
          low[v] = std::min(low[v], num[w]);
        }
      } else {
        if (low[v] == num[v]) {
          while (true) {
            i64 w = tstack.back();
            tstack.pop_back();
            onstack[w] = 0;
            sccid[w] = nscc;
            if (w == v) break;
          }
          nscc++;
        }
        top--;
        if (top >= 0) low[dstack[top]] = std::min(low[dstack[top]], low[v]);
      }
    }
  }

  std::vector<i64> bsize(nscc, 0);
  for (i64 v = 0; v < n; v++) bsize[sccid[v]]++;
  std::vector<i64> start(nscc + 1, 0);
  for (i64 b = 0; b < nscc; b++) start[b + 1] = start[b] + bsize[b];
  for (i64 b = 0; b <= nscc; b++) r[b] = start[b];
  std::vector<i64> cursor(start.begin(), start.end() - 1);
  for (i64 v = 0; v < n; v++) p[cursor[sccid[v]]++] = v;
  return nscc;
}
