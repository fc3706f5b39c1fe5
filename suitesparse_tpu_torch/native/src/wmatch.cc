// Weighted maximum-product transversal — the MC64 job-5 analog.
//
// Host equivalent of the reference ecosystem's MC64/HSL weighted
// matching (the static-pivoting pre-step UMFPACK-class solvers use to put
// LARGE entries on the diagonal; Duff & Koster 2001). The unsymmetric
// multifrontal LU's home pivot blocks are chosen by this matching — a
// structural transversal can select numerically tiny pivots (the
// delayed-pivot failure mode); maximizing the product of matched
// magnitudes removes the root cause.
//
// Algorithm: successive shortest augmenting paths with dual potentials
// (Jonker-Volgenant style) on costs c(r,j) = log(cmax_j) - log|A(r,j)|
// (>= 0; +inf for zeros). Per column: sparse Dijkstra over alternating
// paths; potential update keeps reduced costs nonnegative and matched
// edges tight. Fresh implementation from the published scheme.
//
// match[j] = row matched to column j (-1 if structurally unmatched).
// Returns the number of matched columns.

#include "common.h"
#include <cmath>
#include <queue>
#include <limits>

SSTPU_API i64 sstpu_wmatch(i64 nrow, i64 ncol, const i64* Ap, const i64* Ai,
                           const double* Ax, i64* match) {
  const double INF = std::numeric_limits<double>::infinity();
  // costs per entry: log(cmax_j / |a|)
  std::vector<double> cost(Ap[ncol]);
  for (i64 j = 0; j < ncol; j++) {
    double cmax = 0.0;
    for (i64 p = Ap[j]; p < Ap[j + 1]; p++)
      cmax = std::max(cmax, std::fabs(Ax[p]));
    double lc = cmax > 0 ? std::log(cmax) : 0.0;
    for (i64 p = Ap[j]; p < Ap[j + 1]; p++) {
      double a = std::fabs(Ax[p]);
      cost[p] = a > 0 ? lc - std::log(a) : INF;
    }
  }

  std::vector<double> p_row(nrow, 0.0), q_col(ncol, 0.0);
  std::vector<i64> match_row(nrow, -1);
  for (i64 j = 0; j < ncol; j++) match[j] = -1;

  std::vector<double> d(nrow, INF);
  std::vector<i64> pred(nrow, -1);          // column used to reach row
  std::vector<i64> stamp(nrow, -1), settled(nrow, -1);
  std::vector<i64> settled_rows;
  using QE = std::pair<double, i64>;
  i64 nmatched = 0;

  for (i64 j0 = 0; j0 < ncol; j0++) {
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
    settled_rows.clear();
    auto relax = [&](i64 j, double base) {
      for (i64 p = Ap[j]; p < Ap[j + 1]; p++) {
        i64 r = Ai[p];
        if (settled[r] == j0) continue;
        if (cost[p] == INF) continue;
        double nd = base + cost[p] - q_col[j] - p_row[r];
        if (stamp[r] != j0 || nd < d[r]) {
          stamp[r] = j0;
          d[r] = nd;
          pred[r] = j;
          heap.push({nd, r});
        }
      }
    };
    relax(j0, 0.0);
    i64 r_final = -1;
    double D = INF;
    while (!heap.empty()) {
      auto [dr, r] = heap.top();
      heap.pop();
      if (settled[r] == j0 || dr > d[r]) continue;
      settled[r] = j0;
      settled_rows.push_back(r);
      if (match_row[r] < 0) { r_final = r; D = dr; break; }
      relax(match_row[r], dr);
    }
    if (r_final < 0) continue;              // structurally unmatched column
    // potential update BEFORE augmenting: a settled row's tree column is
    // its PRE-augmentation match (the column expanded from it at base
    // d[row]); r_final has no such column and a zero row delta
    for (i64 rs : settled_rows) {
      if (d[rs] > D) continue;
      p_row[rs] += d[rs] - D;
      i64 jm = match_row[rs];               // column reached at d_col=d[rs]
      if (jm >= 0) q_col[jm] += D - d[rs];
    }
    q_col[j0] += D;
    // augment along pred chain
    i64 r = r_final;
    while (true) {
      i64 j = pred[r];
      i64 rnext = match[j];
      match[j] = r;
      match_row[r] = j;
      if (j == j0) break;
      r = rnext;
    }
    nmatched++;
  }
  return nmatched;
}
