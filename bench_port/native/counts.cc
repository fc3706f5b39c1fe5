// Elimination tree, postorder and column counts of a symmetric pattern:
// the benchmark's own frozen copy (Liu 1986; Gilbert, Ng and Peyton 1994;
// CSparse's cs_etree, cs_post and cs_counts), so that the flop count of
// the factor roofline does not move with the program under test.
//
// bench_etree: parent[] of the pattern's upper triangle (CSC, rows <= col).
// bench_postorder: a postorder of that forest.
// bench_col_counts: counts[j] = nnz(L(:, j)), diagonal included, from the
// lower triangle by column (CSC, rows >= col).
#include <cstdint>
#include <vector>

using i64 = int64_t;
#define BENCH_API extern "C" __attribute__((visibility("default")))

BENCH_API void bench_etree(i64 n, const i64* Ap, const i64* Ai, i64* parent) {
  std::vector<i64> ancestor(n, -1);
  for (i64 j = 0; j < n; j++) parent[j] = -1;
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

BENCH_API void bench_postorder(i64 n, const i64* parent, i64* post) {
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
}  // namespace

BENCH_API void bench_col_counts(i64 n, const i64* Ap, const i64* Ai,
                                const i64* parent, const i64* post,
                                i64* counts) {
  std::vector<i64> first(n, -1), maxfirst(n, -1), prevleaf(n, -1), up(n);
  std::vector<i64> delta(n, 0);
  for (i64 j = 0; j < n; j++) up[j] = j;
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    delta[j] = (first[j] == -1) ? 1 : 0;
    for (i64 t = j; t != -1 && first[t] == -1; t = parent[t]) first[t] = k;
  }
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    if (parent[j] != -1) delta[parent[j]] -= 1;
    for (i64 p = Ap[j]; p < Ap[j + 1]; p++) {
      i64 i = Ai[p];
      if (i <= j || first[j] <= maxfirst[i]) continue;
      maxfirst[i] = first[j];
      i64 jprev = prevleaf[i];
      delta[j] += 1;
      if (jprev != -1) delta[uf_find(up, jprev)] -= 1;
      prevleaf[i] = j;
    }
    if (parent[j] != -1) up[j] = parent[j];
  }
  for (i64 j = 0; j < n; j++) counts[j] = delta[j];
  for (i64 k = 0; k < n; k++) {
    i64 j = post[k];
    if (parent[j] != -1) counts[parent[j]] += counts[j];
  }
}
