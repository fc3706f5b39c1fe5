// Nested dissection ordering — multilevel vertex-separator bisection.
//
// Equivalent of the reference's graph-partition ordering stack:
// METIS_NodeND (vendored metis-5.1.0, wrapped by CHOLMOD/Partition/
// cholmod_metis.c:486) and CHOLMOD's own NESDIS (cholmod_nesdis.c) with
// Mongoose-style multilevel machinery (Mongoose_Coarsening/Matching/
// ImproveFM.cpp). Implemented from the published multilevel scheme
// (Karypis-Kumar; Hendrickson-Leland): heavy-edge matching coarsening, BFS
// region-growing initial bisection from a pseudo-peripheral vertex,
// Fiduccia-Mattheyses boundary refinement on uncoarsening, minimum-vertex-
// cover separator extraction from the edge cut, then recursion with AMD on
// small leaf subgraphs (NESDIS's strategy). Fresh code throughout.
//
// Input: symmetric pattern of A+A' in CSC, no diagonal. Output: perm[k] =
// k-th pivot (separators ordered last, recursively).

#include "common.h"
#include <random>
#include <functional>
#include <mutex>

extern "C" i64 sstpu_amd(i64 n, const i64* Ap, const i64* Ai, i64* perm,
                         double dense, i64 aggressive);

namespace {

using i32 = int32_t;

std::mutex g_ws_mu;  // serializes the pooled workspace g_ws

struct Graph {
  // int32 internals: ND graphs are bounded by the A+A' pattern size
  // (entry guards n, nnz < 2^31; -3 otherwise) — halving the adjacency
  // traffic measured ~10% whole-ND on the bandwidth-poor bench host,
  // bit-identical perms (same RNG consumption, no overflow)
  i64 n = 0;
  std::vector<i32> xadj, adj, ewgt, vwgt;
  i64 total_vwgt = 0;
};

// Pooled workspace for the hot per-call arrays (refine/contract/
// initial_bisect ran ~7k times per ND at n=125k; fresh O(n) vectors per
// call were 40% of ND time — the reference's single-workspace discipline,
// amd_1.c style, applied here).  Stamp counters replace per-call clears.
// NOT thread-safe (matches the library's single-threaded host contract).
struct Workspace {
  std::vector<i64> gain, gstamp, mstamp, instamp, hstamp, hgain;
  std::vector<std::pair<i64, i64>> heap;
  std::vector<i64> moves, cand, next_cand, def0, def1, touched;
  i64 tick = 0;
  // contract pools (cmark holds i32 ctick stamps; the counter wraps by
  // re-clearing cmark before overflow — random cmark accesses are the
  // cache-miss hot spot, so halving the bytes pays)
  std::vector<i32> cnt, vlist, fill, cslot, cmark;
  i64 ctick = 0;
  // bfs pools (dist holds btick stamps -> stays i64)
  std::vector<i64> dist;
  std::vector<i32> queue;
  i64 btick = 0;
  void ensure(i64 n) {
    if ((i64)gain.size() < n) {
      gain.resize(n);
      gstamp.resize(n, 0);
      mstamp.resize(n, 0);
      instamp.resize(n, 0);
      hstamp.resize(n, 0);
      hgain.resize(n);
      dist.resize(n, 0);
      queue.resize(n);
    }
  }
  void ensure_c(i64 n, i64 cn) {
    if ((i64)vlist.size() < n) vlist.resize(n);
    if ((i64)cmark.size() < cn) {
      cmark.resize(cn, -1);
      cslot.resize(cn);
    }
  }
};
Workspace g_ws;

// Build the coarse graph from a matching: map[v] = coarse id.
// Flat two-pass construction with marker-based duplicate merging — no
// per-vertex vectors, no sorts (this ran at every coarsening level of every
// recursion node and dominated ND time).
Graph contract(const Graph& g, const std::vector<i32>& cmap, i64 cn) {
  Graph cg;
  cg.n = cn;
  cg.vwgt.assign(cn, 0);
  for (i64 v = 0; v < g.n; v++) cg.vwgt[cmap[v]] += g.vwgt[v];
  cg.total_vwgt = g.total_vwgt;
  // bucket fine vertices by coarse id (counting sort); pooled workspace,
  // stamp-based duplicate marking (no per-call O(cn) clears)
  Workspace& ws = g_ws;
  ws.ensure_c(g.n, cn);
  ws.cnt.assign(cn + 1, 0);
  i32* cnt = ws.cnt.data();
  i32* vlist = ws.vlist.data();
  for (i64 v = 0; v < g.n; v++) cnt[cmap[v] + 1]++;
  for (i64 c = 0; c < cn; c++) cnt[c + 1] += cnt[c];
  ws.fill.assign(ws.cnt.begin(), ws.cnt.end() - 1);
  for (i64 v = 0; v < g.n; v++) vlist[ws.fill[cmap[v]]++] = v;
  cg.xadj.assign(cn + 1, 0);
  cg.adj.reserve(g.adj.size());
  cg.ewgt.reserve(g.adj.size());
  if (ws.ctick + cn > INT32_MAX) {        // i32 stamp wrap: re-clear
    std::fill(ws.cmark.begin(), ws.cmark.end(), -1);
    ws.ctick = 0;
  }
  i32* cmark = ws.cmark.data();
  i32* cslot = ws.cslot.data();
  i64 base = ws.ctick;
  ws.ctick += cn;
  for (i64 c = 0; c < cn; c++) {
    for (i64 t = cnt[c]; t < cnt[c + 1]; t++) {
      i64 v = vlist[t];
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
        i64 cu = cmap[g.adj[p]];
        if (cu == c) continue;
        i32 w = g.ewgt.empty() ? 1 : g.ewgt[p];
        if (cmark[cu] != (i32)(base + c)) {
          cmark[cu] = (i32)(base + c);
          cslot[cu] = (i32)cg.adj.size();
          cg.adj.push_back(cu);
          cg.ewgt.push_back(w);
        } else {
          cg.ewgt[cslot[cu]] += w;
        }
      }
    }
    cg.xadj[c + 1] = (i32)cg.adj.size();
  }
  return cg;
}

// Heavy-edge matching; returns coarse size and cmap.
i64 match(const Graph& g, std::vector<i32>& cmap, std::mt19937_64& rng) {
  std::vector<i32> order(g.n);
  for (i64 i = 0; i < g.n; i++) order[i] = (i32)i;
  std::shuffle(order.begin(), order.end(), rng);
  cmap.assign(g.n, -1);
  i64 cn = 0;
  for (i32 v : order) {
    if (cmap[v] != -1) continue;
    i64 best = -1, bestw = -1;
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
      i64 u = g.adj[p];
      if (cmap[u] != -1 || u == v) continue;
      i64 w = g.ewgt.empty() ? 1 : g.ewgt[p];
      if (w > bestw) { bestw = w; best = u; }
    }
    cmap[v] = (i32)cn;
    if (best != -1) cmap[best] = (i32)cn;
    cn++;
  }
  return cn;
}

// BFS region growing from a pseudo-peripheral vertex; side[v] in {0,1}.
void initial_bisect(const Graph& g, std::vector<char>& side,
                    std::mt19937_64& rng, double target = 0.5) {
  side.assign(g.n, 1);
  if (g.n == 0) return;
  // pseudo-peripheral: BFS twice (pooled queue, stamp-based visited)
  Workspace& ws = g_ws;
  ws.ensure(g.n);
  i64* dist = ws.dist.data();
  i32* queue = ws.queue.data();
  i64 start = (i64)(rng() % g.n);
  for (int rep = 0; rep < 3; rep++) {
    i64 tick = ++ws.btick;
    i64 qh = 0, qt = 0;
    queue[qt++] = start;
    dist[start] = tick;
    if (rep == 2) {
      // grow region 0 from `start` until half the total vertex weight
      i64 grown = 0, goal = (i64)(target * g.total_vwgt);
      while (qh < qt && grown < goal) {
        i64 v = queue[qh++];
        side[v] = 0;
        grown += g.vwgt[v];
        for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
          i64 u = g.adj[p];
          if (dist[u] != tick) { dist[u] = tick; queue[qt++] = u; }
        }
      }
      break;  // disconnected leftovers stay on side 1
    }
    i64 last = start;
    while (qh < qt) {
      i64 v = queue[qh++];
      last = v;
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
        i64 u = g.adj[p];
        if (dist[u] != tick) { dist[u] = tick; queue[qt++] = u; }
      }
    }
    start = last;
  }
}

i64 cut_weight(const Graph& g, const std::vector<char>& side) {
  i64 cut = 0;
  for (i64 v = 0; v < g.n; v++)
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++)
      if (side[g.adj[p]] != side[v]) cut += g.ewgt.empty() ? 1 : g.ewgt[p];
  return cut / 2;
}

// Fiduccia-Mattheyses refinement: per pass, tentatively move every vertex at
// most once in best-gain order (negative-gain moves allowed — hill climbing),
// then roll back to the best balanced prefix. Lazy max-heap with stale-entry
// invalidation instead of METIS's gain buckets (weighted edges).
// ``cand0`` (optional) limits the initial gain scan to a candidate vertex
// list — during uncoarsening only the projection of the coarse boundary can
// start on the cut, so scanning the whole fine graph per pass (the profiled
// 68% of ND time) is wasted; interior vertices get exact gains lazily when
// a neighbor's move first touches them.
i64 refine(const Graph& g, std::vector<char>& side,
           double flo = 0.45, double fhi = 0.55,
           const std::vector<i64>* cand0 = nullptr, i64 w0_in = -1) {
  if (g.n == 0) return 0;
  i64 w0 = w0_in;
  if (w0 < 0) {
    w0 = 0;
    for (i64 v = 0; v < g.n; v++) if (side[v] == 0) w0 += g.vwgt[v];
  }
  i64 W = g.total_vwgt;
  i64 lo = (i64)(flo * W), hi = (i64)(fhi * W) + 1;
  Workspace& ws = g_ws;
  ws.ensure(g.n);
  i64* gain = ws.gain.data();
  i64* gstamp = ws.gstamp.data();   // gain[v] valid iff gstamp[v] == tick
  i64* mstamp = ws.mstamp.data();   // moved iff mstamp[v] == mtick
  std::vector<i64>& moves = ws.moves;
  std::vector<std::pair<i64, i64>>& heap = ws.heap;  // (gain, v), lazy
  // Deduplicated heap: the classic lazy
  // heap re-pushes on EVERY neighbor gain update (~7 entries/vertex at
  // n=125k — 14M heap sifts, 11% of ND). Processing only ever happens at
  // an entry whose key equals the CURRENT gain (the gv == gain[v] check),
  // so entries at yesterday's key are pure overhead: skip the push when a
  // live entry already sits at a key >= the current gain (it will pop
  // early, fail validation, and re-push at the true key — exactly what
  // the classic extra entry achieved). A push at a HIGHER key than the
  // recorded one must still happen, or the vertex would pop late and the
  // processing order would drift from exact descending-gain order (a
  // drift variant measured ±7-25% lnz swings, fixture-dependent).
  constexpr bool fastheap = true;
  i64* hstamp = ws.hstamp.data();   // in-heap iff hstamp[v] == htick
  i64* hgain = ws.hgain.data();     // key of v's highest live entry
  i64 htick = 0;
  auto push = [&](i64 v) {
    if (fastheap) {
      if (hstamp[v] == htick && hgain[v] >= gain[v]) return;
      hstamp[v] = htick;
      hgain[v] = gain[v];
    }
    heap.push_back({gain[v], v});
    std::push_heap(heap.begin(), heap.end());
  };
  auto compute_gain = [&](i64 v) {
    i64 ext = 0, in = 0;
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
      i64 w = g.ewgt.empty() ? 1 : g.ewgt[p];
      if (side[g.adj[p]] != side[v]) ext += w; else in += w;
    }
    gain[v] = ext - in;
    return ext;
  };
  // most of the cut reduction lands in the first passes; large graphs cap
  // the pass count (the per-pass gain scan is O(candidates))
  int max_pass = g.n > 20000 ? 2 : (g.n > 2000 ? 4 : 6);
  std::vector<i64>& cand = ws.cand;  // candidates for the CURRENT pass
  if (cand0) cand.assign(cand0->begin(), cand0->end());
  else { cand.resize(g.n); for (i64 v = 0; v < g.n; v++) cand[v] = v; }
  std::vector<i64>& next_cand = ws.next_cand;
  i64* instamp = ws.instamp.data();
  std::vector<i64>& touched = ws.touched;  // gstamp'd this pass
  for (int pass = 0; pass < max_pass; pass++) {
    i64 tick = ++ws.tick;
    htick = ++ws.tick;
    heap.clear();
    touched.clear();
    for (i64 v : cand) {
      if (gstamp[v] == tick) continue;  // duplicate in candidate list
      gstamp[v] = tick;
      touched.push_back(v);
      if (compute_gain(v) > 0) push(v);
    }
    i64 mtick = ++ws.tick;
    moves.clear();
    // balance-infeasible pops wait per side; a move shifting weight toward
    // a side re-opens that side's deferred vertices (they re-enter the heap
    // and the stale-gain check re-validates them)
    ws.def0.clear(); ws.def1.clear();
    std::vector<i64>* deferred[2] = {&ws.def0, &ws.def1};
    i64 delta = 0, best_delta = 0, best_len = 0, w0_run = w0, best_w0 = w0;
    // FM early termination (METIS-style): unbounded hill climbing lets one
    // pass cascade across the whole graph; cap the non-improving streak
    i64 since_best = 0;
    const i64 streak_limit = std::max<i64>(64, g.n / 256);
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end());
      auto [gv, v] = heap.back();
      heap.pop_back();
      if (fastheap) {
        hstamp[v] = 0;                        // entry consumed
        if (mstamp[v] == mtick) continue;
        if (gv != gain[v]) { push(v); continue; }  // re-enter at true gain
      } else if (mstamp[v] == mtick || gv != gain[v]) {
        continue;  // stale
      }
      i64 nw0 = side[v] == 0 ? w0_run - g.vwgt[v] : w0_run + g.vwgt[v];
      if (nw0 < lo || nw0 > hi) {              // infeasible now; retry when
        deferred[side[v]]->push_back(v);       // balance shifts this way
        continue;
      }
      mstamp[v] = mtick;
      side[v] ^= 1;
      w0_run = nw0;
      delta += gv;
      moves.push_back(v);
      // side[v] is post-flip: weight moved TO side[v], so vertices deferred
      // on side[v] (whose departure was blocked by that side being too
      // light) may be feasible now
      if (!deferred[side[v]]->empty()) {
        for (i64 u : *deferred[side[v]]) if (mstamp[u] != mtick) push(u);
        deferred[side[v]]->clear();
      }
      if (delta > best_delta) {
        best_delta = delta;
        best_len = (i64)moves.size();
        best_w0 = w0_run;
        since_best = 0;
      } else if (++since_best > streak_limit) {
        break;
      }
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
        i64 u = g.adj[p];
        if (mstamp[u] == mtick) continue;
        if (gstamp[u] != tick) {
          // lazily touched interior vertex: compute its exact gain now
          // (side[v] already flipped, so compute_gain sees current state)
          gstamp[u] = tick;
          touched.push_back(u);
          compute_gain(u);
        } else {
          i64 w = g.ewgt.empty() ? 1 : g.ewgt[p];
          // v left u's side -> u's external weight grew (or shrank)
          gain[u] += (side[u] == side[v]) ? -2 * w : 2 * w;
        }
        push(u);
      }
    }
    // roll back past the best prefix
    for (i64 k = (i64)moves.size() - 1; k >= best_len; k--)
      side[moves[k]] ^= 1;
    w0 = best_w0;
    if (best_delta <= 0) break;
    if (cand0) {
      // next pass: everything this pass computed a gain for (old
      // candidates deduped into `touched` during the scan)
      i64 ntick = ++ws.tick;
      next_cand.clear();
      for (i64 v : touched) if (instamp[v] != ntick) { instamp[v] = ntick;
        next_cand.push_back(v); }
      cand.swap(next_cand);
    }
  }
  return w0;
}

// Vertex separator from the edge cut: MINIMUM vertex cover of the cut's
// bipartite graph via maximum matching + König's theorem (the quality step
// METIS's node-separator refinement approximates; exact here because the
// boundary graphs are small).
void separator(const Graph& g, const std::vector<char>& side,
               std::vector<char>& insep) {
  insep.assign(g.n, 0);
  // boundary vertices per side, with local ids
  std::vector<i64> lid(g.n, -1), bu, bv;
  for (i64 v = 0; v < g.n; v++)
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++)
      if (side[g.adj[p]] != side[v]) {
        if (lid[v] == -1) {
          if (side[v] == 0) { lid[v] = (i64)bu.size(); bu.push_back(v); }
          else { lid[v] = (i64)bv.size(); bv.push_back(v); }
        }
        break;
      }
  i64 nu = (i64)bu.size(), nv = (i64)bv.size();
  if (nu == 0 || nv == 0) return;
  // adjacency bu -> bv over cut edges
  std::vector<std::vector<i64>> adj(nu);
  for (i64 iu = 0; iu < nu; iu++) {
    i64 v = bu[iu];
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
      i64 u = g.adj[p];
      if (side[u] != side[v]) adj[iu].push_back(lid[u]);
    }
  }
  // max bipartite matching — iterative augmenting DFS (the recursive
  // std::function version profiled at ~20% of whole-ND time)
  std::vector<i64> mu(nu, -1), mv(nv, -1);
  std::vector<i64> seen(nv, -1);
  std::vector<i64> ustack, eidx, vpath;
  for (i64 root = 0; root < nu; root++) {
    i64 stamp = root;
    ustack.assign(1, root);
    eidx.assign(1, 0);
    vpath.assign(1, -1);  // V-vertex used to reach ustack[d] (d>0)
    bool found = false;
    while (!ustack.empty()) {
      i64 iu = ustack.back();
      i64& e = eidx.back();
      bool descended = false;
      while (e < (i64)adj[iu].size()) {
        i64 iv = adj[iu][e++];
        if (seen[iv] == stamp) continue;
        seen[iv] = stamp;
        if (mv[iv] == -1) {
          // augment along the path
          mu[iu] = iv;
          mv[iv] = iu;
          for (i64 d = (i64)ustack.size() - 1; d > 0; d--) {
            i64 pu = ustack[d - 1], pv = vpath[d];
            mu[pu] = pv;
            mv[pv] = pu;
          }
          found = true;
          break;
        }
        ustack.push_back(mv[iv]);
        eidx.push_back(0);
        vpath.push_back(iv);
        descended = true;
        break;
      }
      if (found) break;
      if (!descended) { ustack.pop_back(); eidx.pop_back(); vpath.pop_back(); }
    }
  }
  // König: Z = U-vertices unmatched + all reachable by alternating paths
  std::vector<char> zu(nu, 0), zv(nv, 0);
  std::vector<i64> stack;
  for (i64 iu = 0; iu < nu; iu++)
    if (mu[iu] == -1) { zu[iu] = 1; stack.push_back(iu); }
  while (!stack.empty()) {
    i64 iu = stack.back();
    stack.pop_back();
    for (i64 iv : adj[iu]) {
      if (zv[iv]) continue;
      zv[iv] = 1;  // via non-matching edge
      i64 iw = mv[iv];
      if (iw != -1 && !zu[iw]) { zu[iw] = 1; stack.push_back(iw); }
    }
  }
  // minimum cover = (U \ Z) ∪ (V ∩ Z)
  for (i64 iu = 0; iu < nu; iu++) if (!zu[iu]) insep[bu[iu]] = 1;
  for (i64 iv = 0; iv < nv; iv++) if (zv[iv]) insep[bv[iv]] = 1;
}

// Node-separator FM refinement (Ashcraft-Liu / METIS FM_2WayNodeRefine):
// repeatedly move a separator vertex v into one side; v's neighbors on the
// OTHER side get pulled into the separator. gain = w(v) - w(pulled). The
// vertex-cover separator is minimal for the given edge cut; this pass can
// leave that local optimum and shrink |S| directly.
void nodesep_refine(const Graph& g, std::vector<char>& side,
                    std::vector<char>& insep) {
  i64 W = g.total_vwgt;
  i64 w[2] = {0, 0};
  for (i64 v = 0; v < g.n; v++)
    if (!insep[v]) w[side[v]] += g.vwgt[v];
  i64 cap = (i64)(0.65 * W) + 1;
  for (int pass = 0; pass < 8; pass++) {
    bool improved = false;
    for (i64 v = 0; v < g.n; v++) {
      if (!insep[v]) continue;
      i64 best_t = -1, best_gain = 0, best_pull = 0;
      for (int t = 0; t < 2; t++) {
        i64 pull = 0;
        for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
          i64 u = g.adj[p];
          if (!insep[u] && side[u] != t) pull += g.vwgt[u];
        }
        i64 gain = g.vwgt[v] - pull;
        if (w[t] + g.vwgt[v] > cap) continue;
        if (gain > best_gain ||
            (gain == best_gain && best_t != -1 && w[t] < w[best_t])) {
          best_t = t;
          best_gain = gain;
          best_pull = pull;
        }
      }
      if (best_t == -1 || best_gain <= 0) continue;
      // apply: v joins side best_t; other-side neighbors join the separator
      insep[v] = 0;
      side[v] = (char)best_t;
      w[best_t] += g.vwgt[v];
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
        i64 u = g.adj[p];
        if (!insep[u] && side[u] != best_t) {
          insep[u] = 1;
          w[side[u]] -= g.vwgt[u];
        }
      }
      improved = true;
      (void)best_pull;
    }
    if (!improved) break;
  }
}

struct NDContext {
  i64 nd_small;
  std::mt19937_64 rng;
  i64* perm;
  i64* cpos = nullptr;  // optional: block id per elimination POSITION
  i64 nblocks = 0;      // raw block counter (renumbered by caller)
  // search knobs (measured at n=125k: stop=200/restarts=2 beat deeper
  // coarsening AND more restarts on both time and lnz)
  i64 coarsen_stop = 200;
  int restarts = 2;
};

// AMD on an int32 subgraph: sstpu_amd takes i64 arrays. At the nd_small
// leaves the copies are trivial; the no-progress fallback site can pass a
// large subgraph, where the O(nnz) i64 copy is still dominated by AMD
// itself (degenerate-input path, not steady state).
i64 amd_on(const Graph& g, std::vector<i64>& p) {
  std::vector<i64> xa(g.xadj.begin(), g.xadj.end());
  std::vector<i64> ad(g.adj.begin(), g.adj.end());
  p.resize(g.n);
  return sstpu_amd(g.n, xa.data(), ad.data(), p.data(), 10.0, 1);
}

// Order subgraph (vertices vmap into the original) into perm[lo..hi).
void nd_recurse(NDContext& ctx, Graph g, std::vector<i32> vmap,
                i64 lo, i64 hi) {
  i64 n = g.n;
  if (n == 0) return;
  if (n <= ctx.nd_small) {
    // leaf: AMD on the subgraph (NESDIS strategy)
    std::vector<i64> p(n);
    if (amd_on(g, p) != 0)
      for (i64 i = 0; i < n; i++) p[i] = i;
    for (i64 k = 0; k < n; k++) ctx.perm[lo + k] = vmap[p[k]];
    if (ctx.cpos) {
      i64 id = ctx.nblocks++;
      for (i64 k = 0; k < n; k++) ctx.cpos[lo + k] = id;
    }
    return;
  }
  // multilevel bisection
  std::vector<Graph> levels;
  std::vector<std::vector<i32>> cmaps;
  levels.push_back(std::move(g));
  while (levels.back().n > ctx.coarsen_stop) {
    std::vector<i32> cmap;
    i64 cn;
    {
      cn = match(levels.back(), cmap, ctx.rng);
    }
    if (cn > levels.back().n * 9 / 10) break;  // stalled
    Graph cg = contract(levels.back(), cmap, cn);
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(cg));
  }
  // coarsest-level bisection with random restarts (METIS-style: keep the
  // refined candidate with the smallest cut)
  std::vector<char> side, cand;
  i64 best_cut = -1, w0 = -1;
  for (int r = 0; r < ctx.restarts; r++) {
    initial_bisect(levels.back(), cand, ctx.rng);
    i64 w0r = refine(levels.back(), cand);
    i64 cut = cut_weight(levels.back(), cand);
    if (best_cut < 0 || cut < best_cut) {
      best_cut = cut;
      side = cand;
      w0 = w0r;
    }
    if (levels.back().n <= 2) break;
  }
  for (i64 l = (i64)levels.size() - 2; l >= 0; l--) {
    // coarse boundary -> fine candidate list (only boundary projections can
    // start on the cut; refine() touches the rest lazily)
    const Graph& cg = levels[l + 1];
    std::vector<i64> bcand;
    {
      std::vector<char> cbnd(cg.n, 0);
      for (i64 v = 0; v < cg.n; v++)
        for (i64 p = cg.xadj[v]; p < cg.xadj[v + 1]; p++)
          if (side[cg.adj[p]] != side[v]) { cbnd[v] = 1; break; }
      std::vector<char> fine(levels[l].n);
      for (i64 v = 0; v < levels[l].n; v++) {
        fine[v] = side[cmaps[l][v]];
        if (cbnd[cmaps[l][v]]) bcand.push_back(v);
      }
      side.swap(fine);
    }
    // projection preserves side-0 weight (coarse vwgt = sum of fine vwgt)
    w0 = refine(levels[l], side, 0.45, 0.55, &bcand, w0);
  }
  Graph& fg = levels[0];
  std::vector<char> insep;
  {
    separator(fg, side, insep);
    nodesep_refine(fg, side, insep);
  }
  // split into parts
  std::vector<i64> id(fg.n, -1);
  std::vector<i64> a_nodes, b_nodes, s_nodes;
  for (i64 v = 0; v < fg.n; v++) {
    if (insep[v]) s_nodes.push_back(v);
    else if (side[v] == 0) a_nodes.push_back(v);
    else b_nodes.push_back(v);
  }
  if (s_nodes.empty() && (a_nodes.empty() || b_nodes.empty())) {
    // no progress (graph likely disconnected into one side): AMD fallback
    std::vector<i64> p(fg.n);
    if (amd_on(fg, p) != 0)
      for (i64 i = 0; i < fg.n; i++) p[i] = i;
    for (i64 k = 0; k < fg.n; k++) ctx.perm[lo + k] = vmap[p[k]];
    if (ctx.cpos) {
      i64 id = ctx.nblocks++;
      for (i64 k = 0; k < fg.n; k++) ctx.cpos[lo + k] = id;
    }
    return;
  }
  auto build_sub = [&](const std::vector<i64>& nodes, Graph& sg,
                       std::vector<i32>& svmap) {
    i64 sn = (i64)nodes.size();
    for (i64 k = 0; k < sn; k++) id[nodes[k]] = k;
    sg.n = sn;
    sg.vwgt.assign(sn, 1);
    sg.total_vwgt = sn;
    sg.xadj.assign(sn + 1, 0);
    sg.adj.clear();
    sg.ewgt.clear();
    svmap.resize(sn);
    for (i64 k = 0; k < sn; k++) {
      i64 v = nodes[k];
      svmap[k] = vmap[v];
      for (i64 p = fg.xadj[v]; p < fg.xadj[v + 1]; p++) {
        i64 u = fg.adj[p];
        if (!insep[u] && side[u] == side[v]) sg.adj.push_back(id[u]);
      }
      sg.xadj[k + 1] = (i64)sg.adj.size();
    }
    for (i64 k = 0; k < sn; k++) id[nodes[k]] = -1;
  };
  i64 na = (i64)a_nodes.size(), nb = (i64)b_nodes.size(),
      ns = (i64)s_nodes.size();
  // separator ordered last within [lo, hi)
  for (i64 k = 0; k < ns; k++) ctx.perm[hi - ns + k] = vmap[s_nodes[k]];
  if (ctx.cpos && ns > 0) {
    i64 id = ctx.nblocks++;
    for (i64 k = 0; k < ns; k++) ctx.cpos[hi - ns + k] = id;
  }
  Graph ga, gb;
  std::vector<i32> va, vb;
  {
    build_sub(a_nodes, ga, va);
    build_sub(b_nodes, gb, vb);
  }
  levels.clear();  // free memory before recursing
  nd_recurse(ctx, std::move(ga), std::move(va), lo, lo + na);
  nd_recurse(ctx, std::move(gb), std::move(vb), lo + na, lo + na + nb);
}

}  // namespace

// Multilevel nested dissection of the off-diagonal pattern of A+A' (CSC):
// perm[k] = k-th pivot. Returns 0, or -3 when n or nnz exceeds the int32
// internals. cmember: optional per-VERTEX constraint-set ids (NESDIS
// Cmember, cholmod_nesdis.c): leaf blocks and separators, numbered by
// elimination position — the input to constrained AMD. Pass nullptr to
// skip.
SSTPU_API i64 sstpu_nested_dissection_sets(i64 n, const i64* Ap, const i64* Ai,
                                           i64* perm, i64 nd_small, i64 seed,
                                           i64* cmember) {
  if (n <= 0) return 0;
  if (n > INT32_MAX || Ap[n] > INT32_MAX) return -3;  // int32 internals
  // the pooled Workspace (g_ws) is shared state: serialize whole-call
  // (ctypes drops the GIL during foreign calls, so two Python threads CAN
  // get here concurrently; common.h promises thread-safe entry points)
  std::lock_guard<std::mutex> lock(g_ws_mu);
  Graph g;
  g.n = n;
  g.xadj.assign(Ap, Ap + n + 1);
  g.adj.assign(Ai, Ai + Ap[n]);
  g.vwgt.assign(n, 1);
  g.total_vwgt = n;
  NDContext ctx;
  ctx.nd_small = std::max<i64>(nd_small, 16);
  ctx.rng.seed((uint64_t)seed);
  ctx.perm = perm;
  std::vector<i64> cpos;
  if (cmember) {
    cpos.assign(n, 0);
    ctx.cpos = cpos.data();
  }
  std::vector<i32> vmap(n);
  for (i64 i = 0; i < n; i++) vmap[i] = (i32)i;
  nd_recurse(ctx, std::move(g), std::move(vmap), 0, n);
  if (cmember) {
    // renumber blocks ascending by elimination position
    std::vector<i64> newid(ctx.nblocks, -1);
    i64 next = 0;
    for (i64 k = 0; k < n; k++) {
      i64 b = cpos[k];
      if (newid[b] == -1) newid[b] = next++;
      cmember[perm[k]] = newid[b];
    }
  }
  return 0;
}

SSTPU_API i64 sstpu_nested_dissection(i64 n, const i64* Ap, const i64* Ai,
                                      i64* perm, i64 nd_small, i64 seed) {
  return sstpu_nested_dissection_sets(n, Ap, Ai, perm, nd_small, seed,
                                      nullptr);
}

// QP gradient-projection refinement (Mongoose_QPGradProj.cpp /
// Mongoose_QPNapsack.cpp analog): minimize the continuous cut relaxation
// f(x) = x'Lx over the box [0,1]^n intersected with the balance budget
// lo <= w'x <= hi. Projection onto box-and-budget is the napsack problem
// x = clip(y - lambda*w, 0, 1) with lambda found by bisection (w'x is
// monotone in lambda). Rounding picks the balance-feasible prefix of the
// sorted relaxed solution. Fresh implementation from the published method
// (Hager et al.); accepts the result only when the rounded cut improves.
void qp_gradproj(const Graph& g, std::vector<char>& side,
                 double flo, double fhi, int iters = 40) {
  i64 n = g.n;
  if (n == 0) return;
  double W = (double)g.total_vwgt;
  double lo = flo * W, hi = fhi * W;
  std::vector<double> x(n), grad(n), y(n), degw(n, 0.0);
  for (i64 v = 0; v < n; v++)
    for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++)
      degw[v] += g.ewgt.empty() ? 1.0 : (double)g.ewgt[p];
  double maxdeg = 1.0;
  for (i64 v = 0; v < n; v++) maxdeg = std::max(maxdeg, degw[v]);
  double step = 1.0 / (2.0 * maxdeg);
  for (i64 v = 0; v < n; v++) x[v] = side[v] == 0 ? 1.0 : 0.0;

  auto wdot = [&](const std::vector<double>& z) {
    double s = 0;
    for (i64 v = 0; v < n; v++) s += (double)g.vwgt[v] * z[v];
    return s;
  };
  auto project = [&]() {
    // x = clip(y - lambda*w, 0, 1) with w'x in [lo, hi]
    auto eval = [&](double lam) {
      double s = 0;
      for (i64 v = 0; v < n; v++) {
        double w = (double)g.vwgt[v];
        double xv = y[v] - lam * w;
        xv = xv < 0 ? 0 : (xv > 1 ? 1 : xv);
        s += w * xv;
      }
      return s;
    };
    double lam = 0.0;
    double s0 = eval(0.0);
    if (s0 > hi || s0 < lo) {
      double target = s0 > hi ? hi : lo;
      double a = -2.0, b = 2.0;  // y in [-step*grad bounds]; widen if needed
      while (eval(a) < target) a *= 2;
      while (eval(b) > target) b *= 2;
      for (int it = 0; it < 50; it++) {
        lam = 0.5 * (a + b);
        if (eval(lam) > target) a = lam; else b = lam;
      }
    }
    for (i64 v = 0; v < n; v++) {
      double w = (double)g.vwgt[v];
      double xv = y[v] - lam * w;
      x[v] = xv < 0 ? 0 : (xv > 1 ? 1 : xv);
    }
  };

  for (int it = 0; it < iters; it++) {
    for (i64 v = 0; v < n; v++) {
      double s = 0;
      for (i64 p = g.xadj[v]; p < g.xadj[v + 1]; p++) {
        double w = g.ewgt.empty() ? 1.0 : (double)g.ewgt[p];
        s += w * x[g.adj[p]];
      }
      grad[v] = 2.0 * (degw[v] * x[v] - s);
    }
    for (i64 v = 0; v < n; v++) y[v] = x[v] - step * grad[v];
    project();
  }
  (void)wdot;
  // round: balance-feasible prefix of x sorted descending
  std::vector<i64> order(n);
  for (i64 v = 0; v < n; v++) order[v] = v;
  std::sort(order.begin(), order.end(),
            [&](i64 a, i64 b) { return x[a] > x[b]; });
  std::vector<char> cand(n, 1);
  double acc = 0;
  for (i64 v : order) {
    if (acc + g.vwgt[v] > hi) break;
    cand[v] = 0;
    acc += g.vwgt[v];
    if (acc >= lo && x[v] < 0.5) break;  // past the natural threshold
  }
  if (acc < lo) return;                   // could not balance; keep input
  if (cut_weight(g, cand) < cut_weight(g, side)) side.swap(cand);
}

// Mongoose-class edge-cut bipartition (Mongoose.hpp:87-144 EdgeCut): the same
// multilevel machinery as ND but returning the two-way PART VECTOR and cut
// weight instead of a separator ordering. target_split/tolerance mirror
// EdgeCut_Options (default 0.5 / 0.05); returns 0 and fills part[0..n),
// cut_out[0] = cut weight, cut_out[1] = side-0 vertex weight.
SSTPU_API i64 sstpu_edgecut(i64 n, const i64* Ap, const i64* Ai, i64* part,
                            double target_split, double tolerance, i64 seed,
                            i64* cut_out) {
  if (n <= 0) { cut_out[0] = 0; cut_out[1] = 0; return 0; }
  if (n > INT32_MAX || Ap[n] > INT32_MAX) return -3;  // int32 internals
  std::lock_guard<std::mutex> lock(g_ws_mu);  // g_ws serialization
  Graph g;
  g.n = n;
  g.xadj.assign(Ap, Ap + n + 1);
  g.adj.assign(Ai, Ai + Ap[n]);
  g.vwgt.assign(n, 1);
  g.total_vwgt = n;
  std::mt19937_64 rng((uint64_t)seed);
  double flo = std::max(0.0, target_split - tolerance);
  double fhi = std::min(1.0, target_split + tolerance);

  std::vector<Graph> levels;
  std::vector<std::vector<i32>> cmaps;
  levels.push_back(std::move(g));
  while (levels.back().n > 200) {
    std::vector<i32> cmap;
    i64 cn = match(levels.back(), cmap, rng);
    if (cn > levels.back().n * 9 / 10) break;
    Graph cg = contract(levels.back(), cmap, cn);
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(cg));
  }
  std::vector<char> side, cand;
  i64 best_cut = -1;
  for (int r = 0; r < 4; r++) {
    initial_bisect(levels.back(), cand, rng, target_split);
    refine(levels.back(), cand, flo, fhi);
    i64 cut = cut_weight(levels.back(), cand);
    if (best_cut < 0 || cut < best_cut) { best_cut = cut; side = cand; }
    if (levels.back().n <= 2) break;
  }
  for (i64 l = (i64)levels.size() - 2; l >= 0; l--) {
    const Graph& cg = levels[l + 1];
    std::vector<char> cbnd(cg.n, 0);
    for (i64 v = 0; v < cg.n; v++)
      for (i64 p = cg.xadj[v]; p < cg.xadj[v + 1]; p++)
        if (side[cg.adj[p]] != side[v]) { cbnd[v] = 1; break; }
    std::vector<char> fine(levels[l].n);
    std::vector<i64> cand;
    for (i64 v = 0; v < levels[l].n; v++) {
      fine[v] = side[cmaps[l][v]];
      if (cbnd[cmaps[l][v]]) cand.push_back(v);
    }
    side.swap(fine);
    refine(levels[l], side, flo, fhi, &cand);
  }
  // "waterdance" alternation (Mongoose_Waterdance.cpp): FM has run; follow
  // with QP gradient projection, then one more FM pass to clean the
  // rounded boundary. Each stage only replaces the partition on
  // improvement.
  qp_gradproj(levels[0], side, flo, fhi);
  refine(levels[0], side, flo, fhi);
  i64 w0 = 0;
  for (i64 v = 0; v < n; v++) { part[v] = side[v]; if (!side[v]) w0++; }
  cut_out[0] = cut_weight(levels[0], side);
  cut_out[1] = w0;
  return 0;
}
