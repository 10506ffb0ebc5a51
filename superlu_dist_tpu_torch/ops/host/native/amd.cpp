// Approximate minimum-degree ordering on a quotient graph.
//
// Own implementation of the classical AMD scheme (quotient graph of
// variables + elements, approximate external degrees, element
// absorption, supervariable coalescing by hash) — the role GENMMD /
// mmd.c plays in the reference's get_perm_c (reference:
// SRC/prec-independent/mmd.c:1-1025, get_perm_c.c:461-606), written
// from the published algorithm, not ported. The Python
// ordering.minimum_degree is O(n·deg²) with sets and unusable past
// n ≈ 10^4; this runs n = 10^5-scale graphs in well under a second.
//
// C ABI (ctypes): slu_min_degree(n, indptr, indices, perm_out) -> 0/err.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

int64_t slu_min_degree(int64_t n, const int64_t *indptr,
                       const int64_t *indices, int64_t *perm_out) {
    if (n <= 0) return 0;
    using std::vector;
    const int64_t N = n;

    // adjacency of each live variable: element neighbors + variable
    // neighbors (quotient graph). Elements are eliminated variables.
    vector<vector<int32_t>> evec(N), vvec(N);
    // element members (variables absorbed into the element's boundary)
    vector<vector<int32_t>> emem(N);
    vector<int64_t> deg(N), wt(N, 1);       // supervariable weight
    vector<int32_t> state(N, 0);            // 0 live, 1 element, 2 dead,
                                            // 3 merged into supervariable
    vector<int64_t> stamp(N, -1);
    vector<int32_t> merged_into(N, -1);

    for (int64_t v = 0; v < N; ++v) {
        vvec[v].reserve(indptr[v + 1] - indptr[v]);
        for (int64_t t = indptr[v]; t < indptr[v + 1]; ++t) {
            int64_t u = indices[t];
            if (u != v) vvec[v].push_back((int32_t)u);
        }
        std::sort(vvec[v].begin(), vvec[v].end());
        vvec[v].erase(std::unique(vvec[v].begin(), vvec[v].end()),
                      vvec[v].end());
        deg[v] = (int64_t)vvec[v].size();
    }

    // degree buckets (linked lists)
    vector<int32_t> bhead(N + 1, -1), bnext(N, -1), bprev(N, -1);
    vector<int64_t> bdeg(N, -1);
    auto benq = [&](int64_t v, int64_t d) {
        if (d > N) d = N;
        bdeg[v] = d;
        bnext[v] = bhead[d];
        bprev[v] = -1;
        if (bhead[d] >= 0) bprev[bhead[d]] = (int32_t)v;
        bhead[d] = (int32_t)v;
    };
    auto bdel = [&](int64_t v) {
        if (bdeg[v] < 0) return;
        if (bprev[v] >= 0) bnext[bprev[v]] = bnext[v];
        else bhead[bdeg[v]] = bnext[v];
        if (bnext[v] >= 0) bprev[bnext[v]] = bprev[v];
        bdeg[v] = -1;
    };
    for (int64_t v = 0; v < N; ++v) benq(v, deg[v]);

    int64_t mindeg = 0, nordered = 0, tick = 0;
    vector<int32_t> boundary;       // scratch: current element boundary
    vector<int32_t> scratch;

    while (nordered < N) {
        while (mindeg <= N && bhead[mindeg] < 0) ++mindeg;
        if (mindeg > N) break;
        int64_t p = bhead[mindeg];
        bdel(p);
        if (state[p] != 0) continue;

        // ---- form element p: boundary = union of variable neighbors
        // and members of element neighbors, live only ----
        ++tick;
        boundary.clear();
        stamp[p] = tick;
        for (int32_t u : vvec[p]) {
            if (state[u] == 0 && stamp[u] != tick) {
                stamp[u] = tick;
                boundary.push_back(u);
            }
        }
        for (int32_t e : evec[p]) {
            if (state[e] != 1) continue;
            for (int32_t u : emem[e]) {
                if (state[u] == 0 && stamp[u] != tick && u != p) {
                    stamp[u] = tick;
                    boundary.push_back(u);
                }
            }
            emem[e].clear();           // absorbed into p
            state[e] = 2;
            emem[e].shrink_to_fit();
        }

        // order the supervariable chain rooted at p
        perm_out[nordered++] = p;
        // (merged members recorded via merged_into, emitted below)
        state[p] = 1;
        emem[p].assign(boundary.begin(), boundary.end());
        vvec[p].clear();
        vvec[p].shrink_to_fit();
        evec[p].clear();
        evec[p].shrink_to_fit();

        // ---- update boundary variables ----
        for (int32_t u : boundary) {
            // drop dead/absorbed elements, add p
            auto &ev = evec[u];
            scratch.clear();
            for (int32_t e : ev)
                if (state[e] == 1) scratch.push_back(e);
            scratch.push_back((int32_t)p);
            std::sort(scratch.begin(), scratch.end());
            scratch.erase(std::unique(scratch.begin(), scratch.end()),
                          scratch.end());
            ev.assign(scratch.begin(), scratch.end());
            // prune eliminated/boundary-covered variable neighbors:
            // keep live ones not already covered by element p
            auto &vv = vvec[u];
            scratch.clear();
            for (int32_t w : vv)
                if (state[w] == 0 && stamp[w] != tick)
                    scratch.push_back(w);
            vv.assign(scratch.begin(), scratch.end());
        }

        // ---- approximate degrees + supervariable hashing ----
        for (int32_t u : boundary) {
            ++tick;
            stamp[u] = tick;
            int64_t d = 0;
            for (int32_t w : vvec[u])
                if (state[w] == 0 && stamp[w] != tick) {
                    stamp[w] = tick;
                    d += wt[w];
                }
            uint64_t h = 0;
            for (int32_t e : evec[u]) {
                if (state[e] != 1) continue;
                h = h * 1000003u + (uint64_t)e;
                for (int32_t w : emem[e])
                    if (state[w] == 0 && stamp[w] != tick && w != u) {
                        stamp[w] = tick;
                        d += wt[w];
                    }
            }
            deg[u] = d;
            bdel(u);
            benq(u, d);
            if (d < mindeg) mindeg = d;
            (void)h;
        }

        // supervariable coalescing: boundary variables with identical
        // (element list, variable list) merge — detected by direct
        // comparison among boundary members sharing a cheap hash
        if (boundary.size() > 1 && boundary.size() < 4096) {
            vector<std::pair<uint64_t, int32_t>> hs;
            hs.reserve(boundary.size());
            for (int32_t u : boundary) {
                if (state[u] != 0) continue;
                uint64_t h = 1469598103934665603ull;
                for (int32_t e : evec[u]) h = (h ^ (uint64_t)e) *
                    1099511628211ull;
                for (int32_t w : vvec[u]) h = (h ^ (uint64_t)(w + N)) *
                    1099511628211ull;
                hs.emplace_back(h, u);
            }
            std::sort(hs.begin(), hs.end());
            for (size_t i = 0; i + 1 < hs.size();) {
                size_t j = i + 1;
                while (j < hs.size() && hs[j].first == hs[i].first) ++j;
                for (size_t a = i; a < j; ++a) {
                    int32_t u = hs[a].second;
                    if (state[u] != 0) continue;
                    for (size_t b = a + 1; b < j; ++b) {
                        int32_t w = hs[b].second;
                        if (state[w] != 0) continue;
                        if (evec[u] == evec[w] && vvec[u] == vvec[w]) {
                            // merge w into u
                            wt[u] += wt[w];
                            state[w] = 3;
                            merged_into[w] = u;
                            bdel(w);
                            vvec[w].clear();
                            vvec[w].shrink_to_fit();
                            evec[w].clear();
                            evec[w].shrink_to_fit();
                        }
                    }
                }
                i = j;
            }
        }
    }

    // emit merged supervariable members right after their representative
    // (any order consistent with the representative's position is valid)
    vector<vector<int32_t>> members(N);
    for (int64_t v = 0; v < N; ++v)
        if (state[v] == 3) {
            int64_t r = v;
            while (merged_into[r] >= 0) r = merged_into[r];
            members[r].push_back((int32_t)v);
        }
    vector<int64_t> out;
    out.reserve(N);
    for (int64_t i = 0; i < nordered; ++i) {
        int64_t v = perm_out[i];
        out.push_back(v);
        for (int32_t m : members[v]) out.push_back(m);
    }
    // any stragglers (isolated vertices)
    {
        vector<char> seen(N, 0);
        for (int64_t v : out) seen[v] = 1;
        for (int64_t v = 0; v < N; ++v)
            if (!seen[v]) out.push_back(v);
    }
    if ((int64_t)out.size() != N) return -1;
    std::memcpy(perm_out, out.data(), sizeof(int64_t) * N);
    return 0;
}

}  // extern "C"
