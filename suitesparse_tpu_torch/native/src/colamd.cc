// Column approximate minimum degree ordering on row lists — the LU/QR
// ordering that never forms A'A.
//
// Equivalent of the reference COLAMD/CCOLAMD packages
// (``COLAMD/Source/colamd.c`` init_rows_cols/init_scoring/find_ordering/
// detect_super_cols, ``CCOLAMD/Source/ccolamd.c`` constraint sets).
// Algorithm from Davis, Gilbert, Larimore & Ng, "A column approximate
// minimum degree ordering algorithm" (ACM TOMS 2004). Fresh implementation:
// row/column lists live in one pooled arena (header-tagged blocks with
// relocation + linear compaction; see IdxLists) with in-scan pruning;
// monotone 64-bit tag marks instead of wrap-around clear_mark; constraint
// sets
// handled by per-set degree-list rebuilds (CCOLAMD keeps one global
// structure with in-set selection) — O(live) per set boundary, fine for the
// NESDIS-scale set counts this library produces.
//
// Semantics preserved from the reference contract:
//   * dense columns (deg > max(16, dense_col*sqrt(min(m,n)))) and empty
//     columns are ordered last (within their constraint set), dense rows
//     (deg > max(16, dense_row*sqrt(n))) are removed from the problem;
//   * column score = approximate external degree of the union of its rows,
//     via per-pivot set differences on row marks;
//   * aggressive row absorption when a row's set difference hits zero;
//   * supercolumn detection by (hash, length, score) then exact pattern
//     compare, absorbed columns ordered contiguously after their principal
//     (order_children analog, same-set merges only);
//   * mass elimination: columns whose live pattern collapses to the pivot
//     row alone are ordered with the pivot.
//
// Output: porder[k] = column placed kth (a permutation of 0..ncol-1).
// Returns 0 on success.

#include "common.h"
#include <cmath>
#include <cstring>

namespace {

// Pooled list-of-lists storage: ONE bump arena holding every list, two
// header words [owner, blockcap] ahead of each payload, relocation to the
// arena top on growth, linear-walk compaction when the arena fills.
// Replaces vector<vector<i64>> (180k separate heap blocks at 100k x 80k —
// the allocator churn and locality loss were most of colamd's constant
// factor). Same idea as the reference's single integer
// workspace (colamd.c garbage_collection), realized with explicit
// start/len/cap tables and header-tagged blocks instead of negated
// row-start encodings.
struct IdxLists {
  std::vector<i64> data;
  std::vector<i64> start, len, cap;
  i64 top = 0;

  // lay out nlists lists with the given capacities back to back
  void init(i64 nlists, const std::vector<i64>& caps, i64 extra) {
    start.assign(nlists, 0);
    len.assign(nlists, 0);
    cap.assign(nlists, 0);
    i64 need = 2 * nlists + extra;
    for (i64 i = 0; i < nlists; i++) need += caps[i];
    data.resize(need);
    top = 0;
    for (i64 i = 0; i < nlists; i++) {
      data[top] = i;
      data[top + 1] = caps[i];
      start[i] = top + 2;
      cap[i] = caps[i];
      top += caps[i] + 2;
    }
  }
  i64* ptr(i64 i) { return data.data() + start[i]; }
  const i64* ptr(i64 i) const { return data.data() + start[i]; }
  i64 size(i64 i) const { return len[i]; }
  void clear_list(i64 i) {
    if (cap[i] > 0) data[start[i] - 2] = -1;  // free the block
    len[i] = 0;
    cap[i] = 0;
  }
  // compact live blocks down, shrinking caps to len + small slack
  void gc() {
    i64 r = 0, w = 0;
    while (r < top) {
      i64 owner = data[r], bc = data[r + 1];
      if (owner >= 0 && start[owner] == r + 2) {
        i64 l = len[owner];
        // small regrowth slack, but NEVER beyond the original block: the
        // write cursor must not overtake the read cursor
        i64 nc = std::min(l + 2, bc);
        data[w] = owner;
        data[w + 1] = nc;
        if (w + 2 != r + 2)
          std::memmove(data.data() + w + 2, data.data() + r + 2,
                       (size_t)l * sizeof(i64));
        start[owner] = w + 2;
        cap[owner] = nc;
        w += nc + 2;
      }
      r += bc + 2;
    }
    top = w;
  }
  void ensure(i64 need) {
    if (top + need + 2 > (i64)data.size()) {
      gc();
      if (top + need + 2 > (i64)data.size())
        data.resize(std::max<i64>((i64)data.size() * 3 / 2,
                                  top + need + 2));
    }
  }
  void relocate(i64 i, i64 newcap) {
    ensure(newcap);  // may compact (start[] stays valid; raw ptrs do not)
    i64 ns = top + 2;
    data[top] = i;
    data[top + 1] = newcap;
    std::memmove(data.data() + ns, data.data() + start[i],
                 (size_t)len[i] * sizeof(i64));
    if (cap[i] > 0) data[start[i] - 2] = -1;
    start[i] = ns;
    cap[i] = newcap;
    top = ns + newcap;
  }
  void push(i64 i, i64 v) {
    if (len[i] == cap[i]) relocate(i, cap[i] + (cap[i] >> 1) + 4);
    data[start[i] + len[i]++] = v;
  }
  void assign(i64 i, const i64* src, i64 n) {
    if (n > cap[i]) relocate(i, n + (n >> 2));
    std::memmove(data.data() + start[i], src, (size_t)n * sizeof(i64));
    len[i] = n;
  }
  bool equal(i64 a, i64 b) const {
    return len[a] == len[b] &&
           std::memcmp(ptr(a), ptr(b), (size_t)len[a] * sizeof(i64)) == 0;
  }
};

struct ColamdState {
  i64 nrow, ncol;
  IdxLists colrows;  // live rows per column (lazy prune)
  IdxLists rowcols;  // live cols per row (lazy prune)
  std::vector<i64> row_degree;            // thickness-weighted live col count
  std::vector<i64> row_mark;              // set-difference tags; -1 = dead
  std::vector<i64> thickness;             // cols represented; <=0 while tagged
  std::vector<char> col_dead;             // 0 live, 1 dead-principal, 2 merged
  std::vector<i64> parent;                // supercolumn absorption tree
  std::vector<i64> score;                 // approximate external degree
  std::vector<i64> order;                 // output rank, -1 = unset
  std::vector<i64> cset;                  // constraint set per column
  // degree lists (current constraint set only)
  std::vector<i64> head, dnext, dprev;
  i64 min_score = 0;
  i64 tag = 1;

  bool row_alive(i64 r) const { return row_mark[r] >= 0; }
  void kill_row(i64 r) { row_mark[r] = -1; }

  void list_remove(i64 c) {
    i64 p = dprev[c], n = dnext[c];
    if (p >= 0) dnext[p] = n; else head[score[c]] = n;
    if (n >= 0) dprev[n] = p;
    dprev[c] = dnext[c] = -2;  // not in any list
  }
  void list_insert(i64 c) {
    i64 s = score[c];
    dnext[c] = head[s];
    dprev[c] = -1;
    if (head[s] >= 0) dprev[head[s]] = c;
    head[s] = c;
    if (s < min_score) min_score = s;
  }
};

}  // namespace

// porder[k] = kth column. cmember may be null (single set). Returns 0.
SSTPU_API i64 sstpu_colamd(i64 nrow, i64 ncol, const i64* Ap, const i64* Ai,
                           double dense_row, double dense_col, i64 aggressive,
                           const i64* cmember, i64* porder) {
  if (ncol == 0) return 0;
  ColamdState st;
  st.nrow = nrow;
  st.ncol = ncol;
  st.row_degree.assign(nrow, 0);
  st.row_mark.assign(nrow, 0);
  st.thickness.assign(ncol, 1);
  st.col_dead.assign(ncol, 0);
  st.parent.assign(ncol, -1);
  st.score.assign(ncol, 0);
  st.order.assign(ncol, -1);
  st.head.assign(ncol + 2, -1);
  st.dnext.assign(ncol, -2);
  st.dprev.assign(ncol, -2);
  st.cset.assign(ncol, 0);

  // --- constraint sets -> contiguous output ranges -----------------------
  i64 nsets = 1;
  if (cmember) {
    for (i64 c = 0; c < ncol; c++) {
      st.cset[c] = std::max<i64>(cmember[c], 0);
      nsets = std::max(nsets, st.cset[c] + 1);
    }
  }
  std::vector<i64> set_count(nsets, 0);
  for (i64 c = 0; c < ncol; c++) set_count[st.cset[c]]++;
  std::vector<i64> set_off(nsets + 1, 0);
  for (i64 s = 0; s < nsets; s++) set_off[s + 1] = set_off[s] + set_count[s];
  // live columns ordered from the front of the set range, dense/empty from
  // the back (natural order at the set's end, the reference contract)
  std::vector<i64> set_back(nsets);
  for (i64 s = 0; s < nsets; s++) set_back[s] = set_off[s + 1];

  // --- build row and column lists (dedupe; input need not be sorted) ----
  {
    // columns: sort+unique into the arena (slack 4: columns grow by at most
    // one appended pivot row per elimination step they participate in)
    std::vector<i64> caps(ncol);
    for (i64 c = 0; c < ncol; c++) caps[c] = Ap[c + 1] - Ap[c] + 4;
    st.colrows.init(ncol, caps, 0);
    std::vector<i64> scratch;
    for (i64 c = 0; c < ncol; c++) {
      scratch.assign(Ai + Ap[c], Ai + Ap[c + 1]);
      std::sort(scratch.begin(), scratch.end());
      scratch.erase(std::unique(scratch.begin(), scratch.end()),
                    scratch.end());
      st.colrows.assign(c, scratch.data(), (i64)scratch.size());
      for (i64 r : scratch) st.row_degree[r]++;
    }
    // rows: counting layout, filled from the column lists (rows only ever
    // get REPLACED patterns later — the resurrected pivot row — so slack 0)
    caps.assign(st.row_degree.begin(), st.row_degree.end());
    st.rowcols.init(nrow, caps, 0);
    for (i64 c = 0; c < ncol; c++) {
      const i64* rows = st.colrows.ptr(c);
      for (i64 t = 0; t < st.colrows.size(c); t++) {
        i64 r = rows[t];
        st.rowcols.data[st.rowcols.start[r] + st.rowcols.len[r]++] = c;
      }
    }
  }

  // --- kill empty/dense columns (order at the back of their set) --------
  i64 dense_col_cut = dense_col < 0 ? nrow - 1
      : (i64)std::max(16.0, dense_col * std::sqrt((double)std::min(nrow, ncol)));
  i64 dense_row_cut = dense_row < 0 ? ncol - 1
      : (i64)std::max(16.0, dense_row * std::sqrt((double)ncol));
  // back positions in natural order: collect then assign ascending
  std::vector<std::vector<i64>> back_cols(nsets);
  for (i64 c = 0; c < ncol; c++) {
    i64 deg = st.colrows.size(c);
    if (deg == 0 || deg > dense_col_cut) {
      st.col_dead[c] = 1;
      back_cols[st.cset[c]].push_back(c);
      if (deg > dense_col_cut) {
        const i64* rows = st.colrows.ptr(c);
        for (i64 t = 0; t < deg; t++) st.row_degree[rows[t]]--;
      }
    }
  }
  // --- kill empty/dense rows --------------------------------------------
  i64 max_deg = 0;
  for (i64 r = 0; r < nrow; r++) {
    if (st.row_degree[r] == 0 || st.row_degree[r] > dense_row_cut)
      st.kill_row(r);
    else
      max_deg = std::max(max_deg, st.row_degree[r]);
  }

  // --- initial scores ----------------------------------------------------
  for (i64 c = 0; c < ncol; c++) {
    if (st.col_dead[c]) continue;
    i64 sc = 0;
    i64* rows = st.colrows.ptr(c);
    i64 w = 0;
    for (i64 t = 0; t < st.colrows.size(c); t++) {
      i64 r = rows[t];
      if (!st.row_alive(r)) continue;
      rows[w++] = r;
      sc = std::min<i64>(sc + st.row_degree[r] - 1, ncol);
    }
    st.colrows.len[c] = w;
    if (w == 0) {  // newly null (all its rows were dense)
      st.col_dead[c] = 1;
      back_cols[st.cset[c]].push_back(c);
    } else {
      st.score[c] = sc;
    }
  }
  // assign back positions (natural ascending order at each set's end)
  for (i64 s = 0; s < nsets; s++) {
    std::sort(back_cols[s].begin(), back_cols[s].end());
    i64 pos = set_off[s + 1] - (i64)back_cols[s].size();
    set_back[s] = pos;
    for (i64 c : back_cols[s]) st.order[c] = pos++;
  }

  // --- hash buckets for supercolumn detection (reset per pivot) ---------
  std::vector<i64> hash_head(ncol + 1, -1), hash_next(ncol, -1);
  std::vector<i64> touched_hashes;
  std::vector<i64> pivot_row_cols;
  std::vector<i64> col_stamp(ncol, 0);  // pivot-row membership tag
  i64 stamp = 1;

  // --- main loop, one constraint set at a time ---------------------------
  for (i64 s = 0; s < nsets; s++) {
    // (re)build degree lists for this set
    std::fill(st.head.begin(), st.head.end(), -1);
    st.min_score = ncol;
    for (i64 c = ncol - 1; c >= 0; c--)  // reverse: natural tie-breaking
      if (!st.col_dead[c] && st.cset[c] == s) st.list_insert(c);

    i64 k = set_off[s];
    i64 k_end = set_back[s];
    while (k < k_end) {
      // --- select pivot column (min score) ---
      while (st.min_score < (i64)st.head.size() && st.head[st.min_score] < 0)
        st.min_score++;
      i64 pc = st.head[st.min_score];
      st.list_remove(pc);
      st.order[pc] = k;
      i64 pc_thick = st.thickness[pc];
      k += pc_thick;

      // --- pivot row pattern: union of live columns of pc's live rows ---
      stamp++;
      pivot_row_cols.clear();
      i64 pivot_row_degree = 0;
      col_stamp[pc] = stamp;  // exclude the pivot column itself
      i64 pivot_row = -1;
      const i64* pc_rows = st.colrows.ptr(pc);
      for (i64 t = 0; t < st.colrows.size(pc); t++) {
        i64 r = pc_rows[t];
        if (!st.row_alive(r)) continue;
        if (pivot_row < 0) pivot_row = r;  // reuse first live row's id
        const i64* rcols = st.rowcols.ptr(r);
        for (i64 u = 0; u < st.rowcols.size(r); u++) {
          i64 c = rcols[u];
          if (st.col_dead[c] || col_stamp[c] == stamp) continue;
          col_stamp[c] = stamp;
          pivot_row_cols.push_back(c);
          pivot_row_degree += st.thickness[c];
        }
        st.kill_row(r);
      }
      max_deg = std::max(max_deg, pivot_row_degree);

      // --- set differences: |r \ pivot_row| per live row of each column --
      // row_mark[r] = tag + set_difference once seen this pivot
      i64 tag = st.tag;
      st.tag += max_deg + 2;  // monotone, no wrap (i64)
      for (i64 c : pivot_row_cols) {
        if (st.dprev[c] != -2 || st.dnext[c] != -2) st.list_remove(c);
        const i64* crows = st.colrows.ptr(c);
        for (i64 t = 0; t < st.colrows.size(c); t++) {
          i64 r = crows[t];
          if (!st.row_alive(r)) continue;
          i64 diff = st.row_mark[r] >= tag ? st.row_mark[r] - tag
                                           : st.row_degree[r];
          diff -= st.thickness[c];
          if (diff == 0 && aggressive) {
            st.kill_row(r);  // aggressive absorption: r subset of pivot row
          } else {
            st.row_mark[r] = tag + diff;
          }
        }
      }

      // --- per-column scores + hash, prune dead rows, mass elimination --
      touched_hashes.clear();
      for (i64 c : pivot_row_cols) {
        i64* rows = st.colrows.ptr(c);
        i64 w = 0;
        i64 sc = 0;
        u64 h = 0;
        for (i64 t = 0; t < st.colrows.size(c); t++) {
          i64 r = rows[t];
          if (!st.row_alive(r)) continue;
          rows[w++] = r;
          h += (u64)r;
          sc = std::min<i64>(sc + (st.row_mark[r] - tag), ncol);
        }
        st.colrows.len[c] = w;
        if (w == 0) {
          // mass elimination: only the pivot row remains -> order with pivot
          // (same-set only; other sets' columns wait for their own range)
          if (st.cset[c] == s) {
            st.col_dead[c] = 1;
            pivot_row_degree -= st.thickness[c];
            st.order[c] = k;
            k += st.thickness[c];
            st.score[c] = -1;  // sentinel: not in hash table
            continue;
          }
          // different set: keep alive with empty rows; it will re-score 0
        }
        st.score[c] = sc;
        i64 hh = (i64)(h % (u64)(ncol + 1));
        hash_next[c] = hash_head[hh];
        if (hash_head[hh] < 0) touched_hashes.push_back(hh);
        hash_head[hh] = c;
      }

      // --- supercolumn detection within hash buckets --------------------
      for (i64 hh : touched_hashes) {
        for (i64 super_c = hash_head[hh]; super_c >= 0;
             super_c = hash_next[super_c]) {
          if (st.col_dead[super_c]) continue;
          i64 len = st.colrows.size(super_c);
          for (i64 c = hash_next[super_c]; c >= 0; c = hash_next[c]) {
            if (st.col_dead[c] || c == super_c) continue;
            if (st.colrows.size(c) != len ||
                st.score[c] != st.score[super_c] ||
                st.cset[c] != st.cset[super_c])
              continue;
            // exact pattern compare (both lists pruned in the same order)
            if (!st.colrows.equal(c, super_c)) continue;
            st.thickness[super_c] += st.thickness[c];
            st.parent[c] = super_c;
            st.col_dead[c] = 2;  // non-principal
            st.colrows.clear_list(c);
          }
        }
        hash_head[hh] = -1;
      }

      // --- finalize: append pivot row to columns, rescore, re-list ------
      st.col_dead[pc] = 1;
      st.colrows.clear_list(pc);
      size_t w = 0;
      for (i64 c : pivot_row_cols) {
        if (st.col_dead[c]) continue;
        pivot_row_cols[w++] = c;
        if (pivot_row >= 0) st.colrows.push(c, pivot_row);
        i64 sc = st.score[c] + pivot_row_degree - st.thickness[c];
        i64 cap = ncol - k - st.thickness[c];
        sc = std::max<i64>(0, std::min(sc, std::max<i64>(cap, 0)));
        st.score[c] = sc;
        if (st.cset[c] == s) st.list_insert(c);
      }
      pivot_row_cols.resize(w);

      // --- resurrect the pivot row with the merged pattern --------------
      if (pivot_row >= 0 && pivot_row_degree > 0) {
        st.rowcols.assign(pivot_row, pivot_row_cols.data(),
                          (i64)pivot_row_cols.size());
        st.row_degree[pivot_row] = pivot_row_degree;
        st.row_mark[pivot_row] = 0;  // alive
      } else if (pivot_row >= 0) {
        st.kill_row(pivot_row);
      }
    }
  }

  // --- order absorbed (non-principal) columns after their principal -----
  // order_children analog. The principal's k-advance in the main loop
  // reserved thickness-many consecutive slots; absorbed columns have
  // IDENTICAL patterns to their principal, so any order among them is
  // fill-equivalent — assign subtree slots by DFS over the absorption tree.
  {
    std::vector<i64> child_head(ncol, -1), child_next(ncol, -1);
    for (i64 c = 0; c < ncol; c++) {
      if (st.col_dead[c] != 2) continue;
      i64 p = st.parent[c];
      child_next[c] = child_head[p];
      child_head[p] = c;
    }
    std::vector<i64> stack;
    for (i64 p = 0; p < ncol; p++) {
      if (st.col_dead[p] != 1 || child_head[p] < 0) continue;
      i64 ord = st.order[p] + 1;
      stack.clear();
      for (i64 c = child_head[p]; c >= 0; c = child_next[c])
        stack.push_back(c);
      while (!stack.empty()) {
        i64 c = stack.back();
        stack.pop_back();
        st.order[c] = ord++;
        for (i64 cc = child_head[c]; cc >= 0; cc = child_next[cc])
          stack.push_back(cc);
      }
    }
  }
  for (i64 c = 0; c < ncol; c++) porder[st.order[c]] = c;
  return 0;
}
