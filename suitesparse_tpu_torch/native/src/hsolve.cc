// Host CSC triangular solves (cs_lsolve/cs_ltsolve/cs_usolve/cs_utsolve
// analogs, CSparse/Source/cs_*solve.c semantics) for the port's simplicial
// factors and the host QR's R: L lower triangular with the DIAGONAL FIRST in
// each column (lsolve: L x = b, ltsolve: L' x = b), U upper triangular with
// the DIAGONAL LAST (usolve: U x = b, utsolve: U' x = b). x is one RHS
// (f64), solved in place. Returns 0. sstpu_offupdate is the KLU block
// back-substitution's update of the earlier blocks (numeric/lu.py).

#include "common.h"

SSTPU_API i64 sstpu_lsolve(i64 n, const i64* Lp, const i64* Li,
                           const double* Lx, double* x) {
  for (i64 j = 0; j < n; j++) {
    i64 p0 = Lp[j], p1 = Lp[j + 1];
    double xj = x[j] / Lx[p0];
    x[j] = xj;
    for (i64 p = p0 + 1; p < p1; p++) x[Li[p]] -= Lx[p] * xj;
  }
  return 0;
}

SSTPU_API i64 sstpu_ltsolve(i64 n, const i64* Lp, const i64* Li,
                            const double* Lx, double* x) {
  for (i64 j = n - 1; j >= 0; j--) {
    i64 p0 = Lp[j], p1 = Lp[j + 1];
    double acc = x[j];
    for (i64 p = p0 + 1; p < p1; p++) acc -= Lx[p] * x[Li[p]];
    x[j] = acc / Lx[p0];
  }
  return 0;
}

SSTPU_API i64 sstpu_usolve(i64 n, const i64* Up, const i64* Ui,
                           const double* Ux, double* x) {
  for (i64 j = n - 1; j >= 0; j--) {
    i64 p0 = Up[j], p1 = Up[j + 1];
    double xj = x[j] / Ux[p1 - 1];
    x[j] = xj;
    for (i64 p = p0; p < p1 - 1; p++) x[Ui[p]] -= Ux[p] * xj;
  }
  return 0;
}

SSTPU_API i64 sstpu_utsolve(i64 n, const i64* Up, const i64* Ui,
                            const double* Ux, double* x) {
  for (i64 j = 0; j < n; j++) {
    i64 p0 = Up[j], p1 = Up[j + 1];
    double acc = x[j];
    for (i64 p = p0; p < p1 - 1; p++) acc -= Ux[p] * x[Ui[p]];
    x[j] = acc / Ux[p1 - 1];
  }
  return 0;
}

// off-diagonal block update (klu_solve's Off loop): for each column j in
// [k1, k2), x[Offi[p]] -= Offx[p] * x[j] — one call per BTF block instead
// of a Python loop per column.
SSTPU_API i64 sstpu_offupdate(i64 k1, i64 k2, const i64* Offp,
                              const i64* Offi, const double* Offx,
                              double* x) {
  for (i64 j = k1; j < k2; j++) {
    double xj = x[j];
    if (xj == 0.0) continue;
    for (i64 p = Offp[j]; p < Offp[j + 1]; p++) x[Offi[p]] -= Offx[p] * xj;
  }
  return 0;
}
