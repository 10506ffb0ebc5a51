// Elimination-tree utilities for the host planning pipeline:
// symmetrized etree (Liu's algorithm with path compression) and
// Cholesky column counts (Gilbert–Ng–Peyton leaf counting).
//
// Native counterparts of ops/host/align.py:sym_etree and
// ops/host/colcounts.py — both are O(nnz·α) pointer-chasing loops that
// cost seconds in Python at n≥1e5 (measured 1.9 s at n=125k) and
// milliseconds here. Input is the STRICT LOWER triangle of the
// symmetrized pattern in CSC (the Python wrapper symmetrizes with
// vectorized scipy). Written from the published algorithms (Liu 1986;
// Gilbert, Ng, Peyton SIMAX 1994); the reference ships neither — its
// etree.c computes the column etree of AᵀA for partial pivoting
// (reference: SRC/prec-independent/etree.c:1-431), a different bound
// than the GESP symmetric one used here.

#include <cstdint>
#include <vector>

typedef int64_t i64;
using std::vector;

extern "C" {

// parent_out: (n,) etree of the symmetrized pattern
// cc_out:     (n,) chol column counts (incl. diagonal)
// returns 0 on success
i64 slu_tree_counts(i64 n, const i64* Lp, const i64* Li,
                    i64* parent_out, i64* cc_out) {
    if (n == 0) return 0;
    // strict upper adjacency (transpose of the lower CSC): for column k,
    // its neighbors j < k — what Liu's ascending scan consumes
    vector<i64> up_cnt(n + 1, 0);
    for (i64 j = 0; j < n; ++j)
        for (i64 p = Lp[j]; p < Lp[j + 1]; ++p)
            up_cnt[Li[p] + 1]++;
    for (i64 k = 0; k < n; ++k) up_cnt[k + 1] += up_cnt[k];
    vector<i64> Up(up_cnt);          // advancing copy; up_cnt keeps starts
    vector<i64> Ui(Lp[n]);
    for (i64 j = 0; j < n; ++j)
        for (i64 p = Lp[j]; p < Lp[j + 1]; ++p)
            Ui[Up[Li[p]]++] = j;

    // ---- etree (Liu): ascending k, attach find(j) -> k ----
    vector<i64> parent(n, -1), anc(n, -1);
    for (i64 k = 0; k < n; ++k) {
        for (i64 p = up_cnt[k]; p < up_cnt[k + 1]; ++p) {
            i64 i = Ui[p];           // i < k
            while (i != -1 && i < k) {
                i64 nxt = anc[i];
                anc[i] = k;
                if (nxt == -1) { parent[i] = k; break; }
                i = nxt;
            }
        }
    }
    for (i64 k = 0; k < n; ++k) parent_out[k] = parent[k];

    // ---- postorder (iterative DFS over child lists) ----
    vector<i64> head(n, -1), next(n, -1), post(n);
    for (i64 k = n - 1; k >= 0; --k) {   // prepend: children ascending
        i64 ppar = parent[k];
        if (ppar >= 0) { next[k] = head[ppar]; head[ppar] = k; }
    }
    i64 np = 0;
    vector<i64> stack;
    for (i64 r = 0; r < n; ++r) {
        if (parent[r] != -1) continue;
        stack.push_back(r);
        while (!stack.empty()) {
            i64 v = stack.back();
            i64 c = head[v];
            if (c != -1) {
                head[v] = next[c];   // consume child
                stack.push_back(c);
            } else {
                post[np++] = v;
                stack.pop_back();
            }
        }
    }

    // ---- column counts (GNP leaf counting) ----
    vector<i64> first(n, -1), delta(n, 0);
    for (i64 k = 0; k < n; ++k) {
        i64 j = post[k];
        delta[j] = (first[j] == -1) ? 1 : 0;
        while (j != -1 && first[j] == -1) {
            first[j] = k;
            j = parent[j];
        }
    }
    vector<i64> maxfirst(n, -1), prevleaf(n, -1), sanc(n);
    for (i64 k = 0; k < n; ++k) sanc[k] = k;
    // find with path compression
    auto find = [&](i64 u) {
        i64 r = u;
        while (sanc[r] != r) r = sanc[r];
        while (sanc[u] != r) { i64 nxt = sanc[u]; sanc[u] = r; u = nxt; }
        return r;
    };
    for (i64 k = 0; k < n; ++k) {
        i64 j = post[k];
        if (parent[j] != -1) delta[parent[j]] -= 1;
        for (i64 p = Lp[j]; p < Lp[j + 1]; ++p) {
            i64 i = Li[p];           // i > j: row subtree of i
            if (first[j] > maxfirst[i]) {
                maxfirst[i] = first[j];
                delta[j] += 1;
                i64 q = prevleaf[i];
                if (q != -1) delta[find(q)] -= 1;
                prevleaf[i] = j;
            }
        }
        if (parent[j] != -1) sanc[j] = parent[j];
    }
    for (i64 k = 0; k < n; ++k) cc_out[k] = delta[k];
    for (i64 k = 0; k < n; ++k) {
        i64 j = post[k];
        if (parent[j] != -1) cc_out[parent[j]] += cc_out[j];
    }
    return 0;
}

}  // extern "C"
