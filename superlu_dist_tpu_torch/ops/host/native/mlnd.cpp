// Multilevel nested dissection (METIS-class), native engine.
//
// C++ implementation of the multilevel scheme in ops/host/mlnd.py — the
// role (Par)METIS plays in the reference's get_perm_c dispatch
// (reference: SRC/prec-independent/get_perm_c.c:500-546 METIS_AT_PLUS_A,
// get_perm_c_parmetis.c ParMETIS_V3_NodeND). Original implementation of
// the textbook Karypis–Kumar multilevel family, tuned for TPU block-pool
// density rather than pure edge cut:
//
//   1. coarsening by randomized heavy-edge matching,
//   2. initial bisection of the coarsest graph (deflated power-iteration
//      Fiedler vector + greedy region growing, best balanced cut wins),
//   3. uncoarsening with Fiduccia–Mattheyses boundary refinement
//      (gain heap, ±4% balance window, rollback to the best prefix),
//   4. minimal vertex separator from the refined edge cut via König's
//      theorem (maximum bipartite matching on the boundary subgraph),
//   5. recursion halves-first / separator-last; leaves ordered by the
//      native AMD (amd.cpp); separator vertices anchor-sorted by the
//      mean emission position of their already-ordered neighbors (keeps
//      each ancestor-separator run contiguous, which is what makes the
//      128-wide block pool dense).
//
// The Python mlnd.py is the readable spec and the fallback; this file
// exists because the Python one is minutes at n >= 1e5 while host
// preprocessing must stay well under factor time (VERDICT round-1 #3).
//
// C ABI (ctypes):
//   slu_nested_dissection(n, indptr, indices, leaf_size, seed, perm_out)
//     -> 0 ok / -1 error.  Graph: symmetric pattern, no diagonal.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

using std::vector;
typedef int64_t i64;
typedef int32_t i32;

extern "C" int64_t slu_min_degree(int64_t n, const int64_t *indptr,
                                  const int64_t *indices, int64_t *perm_out);

namespace {

// splitmix64 — deterministic, seedable
struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed * 0x9e3779b97f4a7c15ull + 1) {}
    uint64_t next() {
        uint64_t z = (s += 0x9e3779b97f4a7c15ull);
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        return z ^ (z >> 31);
    }
    i64 below(i64 m) { return m <= 1 ? 0 : (i64)(next() % (uint64_t)m); }
};

// weighted graph in CSR, local (compact) vertex ids
struct Graph {
    i64 n = 0;
    vector<i64> ptr;   // n+1
    vector<i32> idx;
    vector<i64> w;     // edge weights (fine level: 1)
};

void fisher_yates(vector<i32> &a, Rng &rng) {
    for (i64 i = (i64)a.size() - 1; i > 0; --i)
        std::swap(a[i], a[rng.below(i + 1)]);
}

// ---- coarsening: randomized heavy-edge matching -------------------------

// returns number of coarse vertices; cmap[v] = coarse id
i64 heavy_edge_coarsen(const Graph &G, Rng &rng, vector<i32> &cmap) {
    const i64 n = G.n;
    vector<i32> match(n, -1);
    vector<i32> order(n);
    for (i64 v = 0; v < n; ++v) order[v] = (i32)v;
    fisher_yates(order, rng);
    for (i32 v : order) {
        if (match[v] >= 0) continue;
        i32 best = v;
        i64 bw = -1;
        for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
            i32 u = G.idx[e];
            if (u != v && match[u] < 0 && G.w[e] > bw) { best = u; bw = G.w[e]; }
        }
        match[v] = best;
        match[best] = v;
    }
    // compact ids in ascending order of representative = min(v, match)
    i64 nc = 0;
    cmap.assign(n, -1);
    for (i64 v = 0; v < n; ++v) {
        i64 rep = std::min<i64>(v, match[v]);
        if (rep == v) cmap[v] = (i32)nc++;
    }
    for (i64 v = 0; v < n; ++v)
        if (cmap[v] < 0) cmap[v] = cmap[std::min<i64>(v, match[v])];
    return nc;
}

void build_coarse(const Graph &G, const vector<i64> &vw,
                  const vector<i32> &cmap, i64 nc,
                  Graph &Gc, vector<i64> &vwc) {
    vwc.assign(nc, 0);
    for (i64 v = 0; v < G.n; ++v) vwc[cmap[v]] += vw[v];
    // (ci, cj, w) triples, merged by sort
    vector<std::pair<i64, i64>> ed;   // key = ci*nc + cj
    ed.reserve(G.idx.size());
    for (i64 v = 0; v < G.n; ++v) {
        i64 cv = cmap[v];
        for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
            i64 cu = cmap[G.idx[e]];
            if (cu != cv) ed.emplace_back(cv * nc + cu, G.w[e]);
        }
    }
    std::sort(ed.begin(), ed.end(),
              [](const auto &a, const auto &b) { return a.first < b.first; });
    Gc.n = nc;
    Gc.ptr.assign(nc + 1, 0);
    Gc.idx.clear();
    Gc.w.clear();
    for (size_t i = 0; i < ed.size();) {
        size_t j = i;
        i64 wsum = 0;
        while (j < ed.size() && ed[j].first == ed[i].first) wsum += ed[j++].second;
        i64 ci = ed[i].first / nc, cj = ed[i].first % nc;
        Gc.ptr[ci + 1]++;
        Gc.idx.push_back((i32)cj);
        Gc.w.push_back(wsum);
        i = j;
    }
    for (i64 v = 0; v < nc; ++v) Gc.ptr[v + 1] += Gc.ptr[v];
}

// ---- initial bisection ---------------------------------------------------

struct CutBal { double cut, bal; };

CutBal cut_and_balance(const Graph &G, const vector<i64> &vw,
                       const vector<char> &side) {
    i64 cut2 = 0, w1 = 0, total = 0;
    for (i64 v = 0; v < G.n; ++v) {
        total += vw[v];
        if (side[v]) w1 += vw[v];
        for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e)
            if (side[v] != side[G.idx[e]]) cut2 += G.w[e];
    }
    return {cut2 / 2.0, total ? (double)w1 / (double)total : 0.5};
}

// greedy BFS region growing to half the vertex weight
void grow_bisect(const Graph &G, const vector<i64> &vw, i64 seed,
                 vector<char> &side) {
    const i64 n = G.n;
    side.assign(n, 0);
    i64 total = 0;
    for (i64 v = 0; v < n; ++v) total += vw[v];
    const double target = total / 2.0;
    double acc = 0;
    vector<char> visited(n, 0);
    vector<i32> frontier{(i32)seed}, nxt;
    visited[seed] = 1;
    while (!frontier.empty() && acc < target) {
        nxt.clear();
        for (i32 v : frontier) {
            if (acc >= target) break;
            side[v] = 1;
            acc += vw[v];
            for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
                i32 u = G.idx[e];
                if (!visited[u]) { visited[u] = 1; nxt.push_back(u); }
            }
        }
        frontier.swap(nxt);
    }
    if (acc < target)     // disconnected: absorb unvisited to balance
        for (i64 v = 0; v < n && acc < target; ++v)
            if (!visited[v]) { side[v] = 1; acc += vw[v]; }
}

// Fiedler bisection via deflated power iteration on sigma*I - L
// (the coarsest graph is small; dense-free, CSR matvec)
bool fiedler_bisect(const Graph &G, const vector<i64> &vw, Rng &rng,
                    vector<char> &side) {
    const i64 n = G.n;
    if (n < 4 || n > 400) return false;
    vector<double> d(n, 0);
    double maxd = 0;
    for (i64 v = 0; v < n; ++v) {
        for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) d[v] += (double)G.w[e];
        maxd = std::max(maxd, d[v]);
    }
    const double sigma = 2.0 * maxd + 1.0;
    vector<double> x(n), y(n);
    for (i64 v = 0; v < n; ++v)
        x[v] = (double)(rng.next() % 1000003) / 1000003.0 - 0.5;
    for (int it = 0; it < 400; ++it) {
        // y = (sigma I - L) x = sigma x - d x + A x
        for (i64 v = 0; v < n; ++v) {
            double s = (sigma - d[v]) * x[v];
            for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e)
                s += (double)G.w[e] * x[G.idx[e]];
            y[v] = s;
        }
        // deflate the constant vector, normalize
        double mean = 0;
        for (double t : y) mean += t;
        mean /= n;
        double nrm = 0;
        for (i64 v = 0; v < n; ++v) { y[v] -= mean; nrm += y[v] * y[v]; }
        nrm = std::sqrt(nrm);
        if (nrm < 1e-14) return false;
        for (i64 v = 0; v < n; ++v) x[v] = y[v] / nrm;
    }
    vector<i32> order(n);
    for (i64 v = 0; v < n; ++v) order[v] = (i32)v;
    std::sort(order.begin(), order.end(),
              [&](i32 a, i32 b) { return x[a] < x[b]; });
    i64 total = 0;
    for (i64 v = 0; v < n; ++v) total += vw[v];
    double acc = 0;
    side.assign(n, 0);
    for (i64 k = 0; k < n; ++k) {
        side[order[k]] = 1;
        acc += vw[order[k]];
        if (acc >= total / 2.0) break;
    }
    return true;
}

void initial_bisect(const Graph &G, const vector<i64> &vw, Rng &rng,
                    vector<char> &best) {
    vector<vector<char>> cands;
    vector<char> s;
    if (fiedler_bisect(G, vw, rng, s)) cands.push_back(s);
    for (int t = 0; t < 4; ++t) {
        grow_bisect(G, vw, rng.below(G.n), s);
        cands.push_back(s);
    }
    double bestcost = 1e300;
    int besti = -1;
    for (size_t i = 0; i < cands.size(); ++i) {
        CutBal cb = cut_and_balance(G, vw, cands[i]);
        if (cb.bal < 0.02 || cb.bal > 0.98) continue;
        double cost = cb.cut * (1.0 + 4.0 * std::fabs(cb.bal - 0.5));
        if (cost < bestcost) { bestcost = cost; besti = (int)i; }
    }
    best = besti >= 0 ? cands[besti] : cands.back();
}

// ---- Fiduccia–Mattheyses refinement -------------------------------------

// Tight ±4% window on purpose (see mlnd.py _fm_refine for rationale:
// loose windows let mesh cuts drift off-center and the recursion then
// scatters descendant boundaries across ancestor-separator blocks).
void fm_refine(const Graph &G, const vector<i64> &vw, vector<char> &side,
               int passes = 3, double balance = 0.04) {
    const i64 n = G.n;
    i64 total = 0;
    for (i64 v = 0; v < n; ++v) total += vw[v];
    const double lo = (0.5 - balance) * total, hi = (0.5 + balance) * total;
    const double half = total / 2.0;
    vector<i64> g(n);
    vector<char> locked(n);
    vector<i32> moves;
    typedef std::pair<i64, i32> HN;            // (gain, v), max-heap
    for (int pass = 0; pass < passes; ++pass) {
        // gain[v] = external - internal edge weight
        std::fill(g.begin(), g.end(), 0);
        i64 w1 = 0;
        for (i64 v = 0; v < n; ++v) {
            if (side[v]) w1 += vw[v];
            for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e)
                g[v] += side[v] != side[G.idx[e]] ? G.w[e] : -G.w[e];
        }
        std::priority_queue<HN> heap;
        for (i64 v = 0; v < n; ++v)
            if (g[v] > -g[v] || true) {        // boundary only: has ext edge
                bool bnd = false;
                for (i64 e = G.ptr[v]; e < G.ptr[v + 1] && !bnd; ++e)
                    bnd = side[v] != side[G.idx[e]];
                if (bnd) heap.push({g[v], (i32)v});
            }
        std::fill(locked.begin(), locked.end(), 0);
        moves.clear();
        i64 gain_sum = 0, best_sum = 0;
        i64 best_idx = -1;
        double best_dev = std::fabs((double)w1 - half);
        while (!heap.empty()) {
            auto [gv, v] = heap.top();
            heap.pop();
            if (locked[v] || gv != g[v]) continue;
            double nw1 = side[v] ? (double)w1 - vw[v] : (double)w1 + vw[v];
            if (!(lo <= nw1 && nw1 <= hi) &&
                std::fabs(nw1 - half) >= std::fabs((double)w1 - half)) {
                locked[v] = 1;
                continue;
            }
            locked[v] = 1;
            gain_sum += g[v];
            moves.push_back(v);
            w1 = (i64)nw1;
            side[v] = !side[v];
            for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
                i32 u = G.idx[e];
                if (u == (i32)v) continue;
                g[u] += side[u] == side[v] ? -2 * G.w[e] : 2 * G.w[e];
                if (!locked[u]) heap.push({g[u], u});
            }
            g[v] = -g[v];
            double dev = std::fabs((double)w1 - half);
            if (gain_sum > best_sum ||
                (gain_sum == best_sum && dev < best_dev)) {
                best_sum = gain_sum;
                best_idx = (i64)moves.size() - 1;
                best_dev = dev;
            }
        }
        for (i64 i = (i64)moves.size() - 1; i > best_idx; --i)
            side[moves[i]] = !side[moves[i]];
        if (best_idx < 0) break;
    }
}

// reassign disconnected fragments of each side to the other side
// (FM islands scatter rows across blocks; keep largest component/side)
void deisland(const Graph &G, vector<char> &side) {
    const i64 n = G.n;
    vector<i32> comp(n, -1), stack;
    for (int flag = 0; flag < 2; ++flag) {
        std::fill(comp.begin(), comp.end(), -1);
        i32 nc = 0;
        vector<i64> csize;
        for (i64 s = 0; s < n; ++s) {
            if (side[s] != flag || comp[s] >= 0) continue;
            csize.push_back(0);
            stack.assign(1, (i32)s);
            comp[s] = nc;
            while (!stack.empty()) {
                i32 v = stack.back();
                stack.pop_back();
                csize[nc]++;
                for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
                    i32 u = G.idx[e];
                    if (side[u] == flag && comp[u] < 0) {
                        comp[u] = nc;
                        stack.push_back(u);
                    }
                }
            }
            ++nc;
        }
        if (nc <= 1) continue;
        i32 keep = (i32)(std::max_element(csize.begin(), csize.end()) -
                         csize.begin());
        for (i64 v = 0; v < n; ++v)
            if (side[v] == flag && comp[v] != keep) side[v] = !flag;
    }
}

void multilevel_edge_bisect(const Graph &G, Rng &rng, vector<char> &side,
                            i64 coarsest = 160) {
    vector<Graph> gs;
    vector<vector<i64>> vws;
    vector<vector<i32>> cmaps;
    gs.push_back(G);
    vws.emplace_back(G.n, 1);
    while (gs.back().n > coarsest) {
        vector<i32> cmap;
        i64 nc = heavy_edge_coarsen(gs.back(), rng, cmap);
        if (nc >= gs.back().n * 95 / 100) break;    // matching stalled
        Graph Gc;
        vector<i64> vwc;
        build_coarse(gs.back(), vws.back(), cmap, nc, Gc, vwc);
        cmaps.push_back(std::move(cmap));
        gs.push_back(std::move(Gc));
        vws.push_back(std::move(vwc));
    }
    initial_bisect(gs.back(), vws.back(), rng, side);
    fm_refine(gs.back(), vws.back(), side);
    for (i64 l = (i64)cmaps.size() - 1; l >= 0; --l) {
        vector<char> fine(gs[l].n);
        for (i64 v = 0; v < gs[l].n; ++v) fine[v] = side[cmaps[l][v]];
        side.swap(fine);
        fm_refine(gs[l], vws[l], side);
    }
    deisland(G, side);
}

// ---- minimal vertex separator (König) ------------------------------------

// side-1 -> side-0 boundary bipartite graph; max matching by alternating
// BFS augmentation (iterative — no recursion depth limits); König cover.
void vertex_separator(const Graph &G, const vector<char> &side,
                      vector<i32> &sep) {
    sep.clear();
    const i64 n = G.n;
    // compact ids for boundary vertices on each side
    vector<i32> aid(n, -1), bid(n, -1), averts, bverts;
    for (i64 v = 0; v < n; ++v) {
        if (!side[v]) continue;
        for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
            i32 u = G.idx[e];
            if (u == (i32)v || side[u]) continue;
            if (aid[v] < 0) { aid[v] = (i32)averts.size(); averts.push_back((i32)v); }
            if (bid[u] < 0) { bid[u] = (i32)bverts.size(); bverts.push_back(u); }
        }
    }
    const i64 na = averts.size(), nb = bverts.size();
    if (na == 0) return;
    vector<vector<i32>> adj(na);
    for (i64 i = 0; i < na; ++i) {
        i32 v = averts[i];
        for (i64 e = G.ptr[v]; e < G.ptr[v + 1]; ++e) {
            i32 u = G.idx[e];
            if (u != v && !side[u]) adj[i].push_back(bid[u]);
        }
    }
    vector<i32> matchA(na, -1), matchB(nb, -1), parentB(nb, -1);
    vector<i64> stampA(na, -1), stampB(nb, -1);
    vector<i32> q;
    for (i64 a0 = 0; a0 < na; ++a0) {
        // alternating BFS from a0
        q.assign(1, (i32)a0);
        stampA[a0] = a0;
        bool done = false;
        for (size_t h = 0; h < q.size() && !done; ++h) {
            i32 a = q[h];
            for (i32 b : adj[a]) {
                if (stampB[b] == a0) continue;
                stampB[b] = a0;
                parentB[b] = a;
                if (matchB[b] < 0) {
                    // augment along parent chain
                    i32 bb = b;
                    while (true) {
                        i32 aa = parentB[bb];
                        i32 prev = matchA[aa];
                        matchA[aa] = bb;
                        matchB[bb] = aa;
                        if (aa == (i32)a0) break;
                        bb = prev;
                    }
                    done = true;
                    break;
                }
                i32 a2 = matchB[b];
                if (stampA[a2] != (i64)a0) {
                    stampA[a2] = a0;
                    q.push_back(a2);
                }
            }
        }
    }
    // König: Z = unmatched-A + alternating-reachable;
    // cover = (A \ Z) ∪ (B ∩ Z)
    vector<char> zA(na, 0), zB(nb, 0);
    vector<i32> stack;
    for (i64 a = 0; a < na; ++a)
        if (matchA[a] < 0) { zA[a] = 1; stack.push_back((i32)a); }
    while (!stack.empty()) {
        i32 a = stack.back();
        stack.pop_back();
        for (i32 b : adj[a]) {
            if (zB[b]) continue;
            zB[b] = 1;
            i32 a2 = matchB[b];
            if (a2 >= 0 && !zA[a2]) { zA[a2] = 1; stack.push_back(a2); }
        }
    }
    for (i64 a = 0; a < na; ++a)
        if (!zA[a]) sep.push_back(averts[a]);
    for (i64 b = 0; b < nb; ++b)
        if (zB[b]) sep.push_back(bverts[b]);
    std::sort(sep.begin(), sep.end());
}

// ---- induced subgraph / connected components -----------------------------

// global -> local extraction; gmap is an n-sized scratch (reset per call)
void induced(const i64 *gptr, const i64 *gidx, const vector<i64> &verts,
             vector<i32> &gmap, Graph &S) {
    const i64 m = verts.size();
    for (i64 i = 0; i < m; ++i) gmap[verts[i]] = (i32)i;
    S.n = m;
    S.ptr.assign(m + 1, 0);
    S.idx.clear();
    S.w.clear();
    for (i64 i = 0; i < m; ++i) {
        i64 v = verts[i];
        for (i64 e = gptr[v]; e < gptr[v + 1]; ++e) {
            i32 lu = gmap[gidx[e]];
            if (lu >= 0 && gidx[e] != v &&
                (i64)gidx[e] != v) {            // drop self loops
                S.idx.push_back(lu);
                S.w.push_back(1);
                S.ptr[i + 1]++;
            }
        }
    }
    for (i64 i = 0; i < m; ++i) S.ptr[i + 1] += S.ptr[i];
    for (i64 i = 0; i < m; ++i) gmap[verts[i]] = -1;
}

i64 components(const Graph &S, vector<i32> &label) {
    label.assign(S.n, -1);
    i64 nc = 0;
    vector<i32> stack;
    for (i64 s = 0; s < S.n; ++s) {
        if (label[s] >= 0) continue;
        stack.assign(1, (i32)s);
        label[s] = (i32)nc;
        while (!stack.empty()) {
            i32 v = stack.back();
            stack.pop_back();
            for (i64 e = S.ptr[v]; e < S.ptr[v + 1]; ++e) {
                i32 u = S.idx[e];
                if (label[u] < 0) { label[u] = (i32)nc; stack.push_back(u); }
            }
        }
        ++nc;
    }
    return nc;
}

}  // namespace

extern "C" {

int64_t slu_nested_dissection(int64_t n, const int64_t *indptr,
                              const int64_t *indices, int64_t leaf_size,
                              int64_t seed, int64_t *perm_out) {
    if (n <= 0) return 0;
    if (leaf_size < 4) leaf_size = 4;
    Rng rng((uint64_t)seed);
    vector<i32> gmap(n, -1);

    // DFS over the dissection tree: halves first, separator last.
    struct Job { char op; vector<i64> verts; };    // 'd' dissect | 's' sep
    vector<Job> stack, jobs;                        // jobs = emit order
    {
        vector<i64> all(n);
        for (i64 v = 0; v < n; ++v) all[v] = v;
        stack.push_back({'d', std::move(all)});
    }
    Graph S;
    vector<i32> label;
    vector<char> side;
    vector<i32> sep;
    while (!stack.empty()) {
        Job job = std::move(stack.back());
        stack.pop_back();
        if (job.op == 's') { jobs.push_back(std::move(job)); continue; }
        const i64 m = job.verts.size();
        if (m <= leaf_size) {
            job.op = 'l';
            jobs.push_back(std::move(job));
            continue;
        }
        induced(indptr, indices, job.verts, gmap, S);
        i64 nc = components(S, label);
        if (nc > 1) {
            vector<vector<i64>> parts(nc);
            for (i64 i = 0; i < m; ++i)
                parts[label[i]].push_back(job.verts[i]);
            for (i64 c = nc - 1; c >= 0; --c)
                stack.push_back({'d', std::move(parts[c])});
            continue;
        }
        multilevel_edge_bisect(S, rng, side);
        vertex_separator(S, side, sep);
        if (sep.empty() || (i64)sep.size() >= m / 2) {
            job.op = 'l';
            jobs.push_back(std::move(job));
            continue;
        }
        vector<char> in_sep(m, 0);
        for (i32 s : sep) in_sep[s] = 1;
        vector<i64> left, right, sv;
        for (i64 i = 0; i < m; ++i) {
            if (in_sep[i]) sv.push_back(job.verts[i]);
            else if (side[i]) left.push_back(job.verts[i]);
            else right.push_back(job.verts[i]);
        }
        if (left.empty() || right.empty()) {
            job.op = 'l';
            jobs.push_back(std::move(job));
            continue;
        }
        stack.push_back({'s', std::move(sv)});
        stack.push_back({'d', std::move(right)});
        stack.push_back({'d', std::move(left)});
    }

    // emission: leaves via native AMD; separators anchor-sorted by the
    // mean emitted position of their neighbors (mlnd.py:449-456)
    vector<i64> posof(n, -1);
    i64 pos = 0;
    vector<i64> sub_ptr, sub_idx, sub_perm;
    for (auto &job : jobs) {
        const auto &verts = job.verts;
        const i64 m = verts.size();
        if (job.op == 'l') {
            if (m > 2) {
                for (i64 i = 0; i < m; ++i) gmap[verts[i]] = (i32)i;
                sub_ptr.assign(m + 1, 0);
                sub_idx.clear();
                for (i64 i = 0; i < m; ++i) {
                    i64 v = verts[i];
                    for (i64 e = indptr[v]; e < indptr[v + 1]; ++e) {
                        i32 lu = gmap[indices[e]];
                        if (lu >= 0 && indices[e] != v) {
                            sub_idx.push_back(lu);
                            sub_ptr[i + 1]++;
                        }
                    }
                }
                for (i64 i = 0; i < m; ++i) sub_ptr[i + 1] += sub_ptr[i];
                for (i64 i = 0; i < m; ++i) gmap[verts[i]] = -1;
                sub_perm.assign(m, 0);
                if (slu_min_degree(m, sub_ptr.data(), sub_idx.data(),
                                   sub_perm.data()) != 0)
                    for (i64 i = 0; i < m; ++i) sub_perm[i] = i;
                for (i64 i = 0; i < m; ++i) {
                    i64 v = verts[sub_perm[i]];
                    perm_out[pos] = v;
                    posof[v] = pos++;
                }
            } else {
                for (i64 i = 0; i < m; ++i) {
                    perm_out[pos] = verts[i];
                    posof[verts[i]] = pos++;
                }
            }
        } else {
            vector<std::pair<double, i64>> keyed(m);
            for (i64 i = 0; i < m; ++i) {
                i64 v = verts[i];
                double s = 0;
                i64 c = 0;
                for (i64 e = indptr[v]; e < indptr[v + 1]; ++e) {
                    i64 p = posof[indices[e]];
                    if (p >= 0) { s += (double)p; ++c; }
                }
                keyed[i] = {c ? s / c : 0.0, v};
            }
            std::stable_sort(keyed.begin(), keyed.end(),
                             [](const auto &a, const auto &b) {
                                 return a.first < b.first;
                             });
            for (auto &[k, v] : keyed) {
                perm_out[pos] = v;
                posof[v] = pos++;
            }
        }
    }
    return pos == n ? 0 : -1;
}

}  // extern "C"
