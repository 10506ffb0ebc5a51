// Native block symbolic factorization engine.
//
// C++ implementation of the right-looking block fill simulation, slot
// assignment, Schur-update tape generation, elimination levels, and
// triangular-solve level schedules (the hot host-side loops of
// ops/host/symbolic.py). The reference's symbolic machinery is likewise
// native C (reference: SRC/prec-independent/symbfact.c, psymbfact.c);
// Python is too slow for the fill simulation on production-size matrices.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).
// All arrays are int64.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using std::vector;
typedef int64_t i64;

namespace {

struct SymResult {
    vector<i64> diag_slot, l_ptr, l_slots, u_ptr, u_slots;
    vector<i64> g_ptr, g_l, g_u, g_t;
    vector<i64> slot_row, slot_col, slot_step;
    vector<i64> step_level, block_parent;
    vector<i64> lsol_gptr, lsol_gslot, lsol_gsrc, lsol_gdst, lsol_dptr,
        lsol_diag;
    vector<i64> usol_gptr, usol_gslot, usol_gsrc, usol_gdst, usol_dptr,
        usol_diag;
};

// merge sorted `add` into sorted-unique `dst`
void merge_into(vector<i64>& dst, const i64* add, size_t n) {
    if (n == 0) return;
    vector<i64> out;
    out.reserve(dst.size() + n);
    std::set_union(dst.begin(), dst.end(), add, add + n,
                   std::back_inserter(out));
    dst.swap(out);
}

void solve_schedule(i64 nb, const vector<vector<i64>>& deps_slot,
                    const vector<vector<i64>>& deps_src, bool forward,
                    vector<i64>& gptr, vector<i64>& gslot,
                    vector<i64>& gsrc, vector<i64>& gdst,
                    vector<i64>& dptr, vector<i64>& diag) {
    vector<i64> level(nb, 0);
    if (forward) {
        for (i64 I = 0; I < nb; ++I)
            for (i64 J : deps_src[I])
                level[I] = std::max(level[I], level[J] + 1);
    } else {
        for (i64 I = nb - 1; I >= 0; --I)
            for (i64 J : deps_src[I])
                level[I] = std::max(level[I], level[J] + 1);
    }
    i64 nlvl = nb ? *std::max_element(level.begin(), level.end()) + 1 : 1;
    // diag grouped by level (stable by index)
    dptr.assign(nlvl + 1, 0);
    for (i64 I = 0; I < nb; ++I) dptr[level[I] + 1]++;
    for (i64 l = 0; l < nlvl; ++l) dptr[l + 1] += dptr[l];
    diag.resize(nb);
    {
        vector<i64> pos(dptr.begin(), dptr.end() - 1);
        for (i64 I = 0; I < nb; ++I) diag[pos[level[I]]++] = I;
    }
    // gemms grouped by destination level
    gptr.assign(nlvl + 1, 0);
    for (i64 I = 0; I < nb; ++I)
        gptr[level[I] + 1] += (i64)deps_src[I].size();
    for (i64 l = 0; l < nlvl; ++l) gptr[l + 1] += gptr[l];
    i64 total = gptr[nlvl];
    gslot.resize(total);
    gsrc.resize(total);
    gdst.resize(total);
    {
        vector<i64> pos(gptr.begin(), gptr.end() - 1);
        for (i64 I = 0; I < nb; ++I) {
            for (size_t t = 0; t < deps_src[I].size(); ++t) {
                i64 p = pos[level[I]]++;
                gslot[p] = deps_slot[I][t];
                gsrc[p] = deps_src[I][t];
                gdst[p] = I;
            }
        }
    }
}

}  // namespace

extern "C" {

SymResult* slu_block_symbolic(i64 nb, i64 n_ab, const i64* ab_i,
                              const i64* ab_j) {
    auto* R = new SymResult();

    // initial block pattern (assumed: diagonal blocks present, coords valid)
    vector<vector<i64>> Ls(nb), Us(nb);
    for (i64 t = 0; t < n_ab; ++t) {
        i64 I = ab_i[t], J = ab_j[t];
        if (I > J)
            Ls[J].push_back(I);
        else if (I < J)
            Us[I].push_back(J);
    }
    for (i64 k = 0; k < nb; ++k) {
        std::sort(Ls[k].begin(), Ls[k].end());
        Ls[k].erase(std::unique(Ls[k].begin(), Ls[k].end()), Ls[k].end());
        std::sort(Us[k].begin(), Us[k].end());
        Us[k].erase(std::unique(Us[k].begin(), Us[k].end()), Us[k].end());
    }

    // ---- right-looking fill simulation (psymbfact analog: parallel
    // over elimination-tree subtrees). Fill produced by a step lands
    // only in columns of its own subtree or in the shared ancestor
    // "top" (the filled struct is ancestor-closed in the etree of the
    // symmetrized block pattern), so T threads process disjoint
    // subtrees independently, buffering their top-column contributions,
    // and a serial pass merges + finishes the top. Reference:
    // SRC/prec-independent/psymbfact.c (distributed); here the
    // shared-memory recast. ----
    vector<vector<i64>> step_rows(nb), step_cols(nb);

    auto fill_step = [&](i64 k, vector<vector<i64>>& Lbuf,
                         vector<vector<i64>>& Ubuf,
                         const vector<char>& mine) {
        step_rows[k] = Ls[k];
        step_cols[k] = Us[k];
        const auto& rows = step_rows[k];
        const auto& cols = step_cols[k];
        if (rows.empty() || cols.empty()) return;
        for (i64 J : cols) {
            auto it = std::upper_bound(rows.begin(), rows.end(), J);
            if (mine.empty() || mine[J])
                merge_into(Ls[J], &*it, rows.end() - it);
            else
                Lbuf[J].insert(Lbuf[J].end(), it, rows.end());
        }
        for (i64 I : rows) {
            auto it = std::upper_bound(cols.begin(), cols.end(), I);
            if (mine.empty() || mine[I])
                merge_into(Us[I], &*it, cols.end() - it);
            else
                Ubuf[I].insert(Ubuf[I].end(), it, cols.end());
        }
    };

    i64 nthreads = 1;
    if (const char* e = std::getenv("SLU_TPU_SYMB_THREADS"))
        nthreads = std::atoll(e);
    else
        nthreads = std::min<i64>(8, std::thread::hardware_concurrency());
    if (nthreads > 1 && nb >= 256) {
        // etree of the symmetrized block pattern (Liu's algorithm with
        // path compression): ancestors contain every filled column
        vector<i64> parent(nb, -1), anc(nb, -1);
        auto find_set = [&](i64 x) {
            i64 r = x;
            while (anc[r] >= 0) r = anc[r];
            while (anc[x] >= 0) { i64 nxt = anc[x]; anc[x] = r; x = nxt; }
            return r;
        };
        // Liu's algorithm (O(nnz·alpha)): process columns m ASCENDING and
        // attach find(i) -> m for every lower neighbor i < m. Grouping by
        // the larger endpoint is load-bearing — a first attempt grouped
        // edges by the smaller endpoint and produced a wrong (ancestor-
        // skipping) tree, which broke the subtree-independence the
        // threaded fill relies on (fill leaked across thread bins and
        // 17% of the blocks went missing).
        {
            vector<vector<i64>> nbr_lo(nb);   // column m -> neighbors i < m
            for (i64 j = 0; j < nb; ++j) {
                for (i64 m : Ls[j]) nbr_lo[m].push_back(j);
                for (i64 m : Us[j]) nbr_lo[m].push_back(j);
            }
            for (i64 m = 0; m < nb; ++m) {
                for (i64 i : nbr_lo[m]) {
                    i64 r = find_set(i);
                    if (r != m && parent[r] < 0) {
                        parent[r] = m;
                        anc[r] = m;
                    }
                }
            }
        }
        // subtree sizes -> top = nodes whose subtree exceeds total/T
        vector<i64> sub(nb, 1);
        for (i64 k2 = 0; k2 < nb; ++k2)
            if (parent[k2] >= 0) sub[parent[k2]] += sub[k2];
        vector<char> in_top(nb, 0);
        i64 thresh_sz = std::max<i64>(nb / (4 * nthreads), 8);
        for (i64 k2 = 0; k2 < nb; ++k2)
            if (sub[k2] > thresh_sz || parent[k2] < 0) in_top[k2] = 1;
        for (i64 k2 = nb - 1; k2 >= 0; --k2)       // ancestor closure
            if (in_top[k2] && parent[k2] >= 0) in_top[parent[k2]] = 1;
        // maximal subtrees -> greedy bins
        vector<i64> comp(nb, -1);
        vector<i64> roots;
        for (i64 k2 = 0; k2 < nb; ++k2)
            if (!in_top[k2] && (parent[k2] < 0 || in_top[parent[k2]]))
                roots.push_back(k2);
        // descending pass assigns each node its root (parents have
        // larger indices in an etree)
        for (i64 r : roots) comp[r] = r;
        for (i64 k2 = nb - 1; k2 >= 0; --k2)
            if (!in_top[k2] && comp[k2] < 0 && parent[k2] >= 0
                && comp[parent[k2]] >= 0)
                comp[k2] = comp[parent[k2]];
        vector<i64> bin_cost(nthreads, 0), bin_of(nb, -1);
        std::sort(roots.begin(), roots.end(),
                  [&](i64 a, i64 b) { return sub[a] > sub[b]; });
        for (i64 r : roots) {
            i64 b = std::min_element(bin_cost.begin(), bin_cost.end())
                - bin_cost.begin();
            bin_of[r] = b;
            bin_cost[b] += sub[r];
        }
        vector<vector<i64>> bin_steps(nthreads);
        vector<i64> top_steps;
        for (i64 k2 = 0; k2 < nb; ++k2) {
            if (in_top[k2] || comp[k2] < 0)
                top_steps.push_back(k2);
            else
                bin_steps[bin_of[comp[k2]]].push_back(k2);
        }
        vector<char> mine_top;  // per-thread ownership mask
        vector<vector<vector<i64>>> Lbufs(nthreads), Ubufs(nthreads);
        vector<std::thread> threads;
        for (i64 t2 = 0; t2 < nthreads; ++t2) {
            Lbufs[t2].resize(nb);
            Ubufs[t2].resize(nb);
            threads.emplace_back([&, t2]() {
                vector<char> mine(nb, 0);
                for (i64 k2 : bin_steps[t2]) mine[k2] = 1;
                for (i64 k2 : bin_steps[t2])
                    fill_step(k2, Lbufs[t2], Ubufs[t2], mine);
            });
        }
        for (auto& th : threads) th.join();
        // merge buffered top contributions, then finish the top serially
        for (i64 t2 = 0; t2 < nthreads; ++t2) {
            for (i64 J = 0; J < nb; ++J) {
                auto& lb = Lbufs[t2][J];
                if (!lb.empty()) {
                    std::sort(lb.begin(), lb.end());
                    lb.erase(std::unique(lb.begin(), lb.end()), lb.end());
                    merge_into(Ls[J], lb.data(), lb.size());
                }
                auto& ub = Ubufs[t2][J];
                if (!ub.empty()) {
                    std::sort(ub.begin(), ub.end());
                    ub.erase(std::unique(ub.begin(), ub.end()), ub.end());
                    merge_into(Us[J], ub.data(), ub.size());
                }
            }
        }
        vector<vector<i64>> noL, noU;
        vector<char> all;
        for (i64 k2 : top_steps)
            fill_step(k2, noL, noU, all);
    } else {
        vector<vector<i64>> noL, noU;
        vector<char> all;
        for (i64 k = 0; k < nb; ++k)
            fill_step(k, noL, noU, all);
    }

    // slot assignment: diag first, then per-step L panels then U panels
    R->diag_slot.resize(nb);
    i64 next_slot = 0;
    for (i64 k = 0; k < nb; ++k) {
        R->diag_slot[k] = next_slot++;
        R->slot_row.push_back(k);
        R->slot_col.push_back(k);
        R->slot_step.push_back(k);
    }
    R->l_ptr.assign(nb + 1, 0);
    R->u_ptr.assign(nb + 1, 0);
    vector<vector<i64>> l_slot_of(nb), u_slot_of(nb);
    for (i64 k = 0; k < nb; ++k) {
        for (i64 I : step_rows[k]) {
            l_slot_of[k].push_back(next_slot);
            R->l_slots.push_back(next_slot);
            R->slot_row.push_back(I);
            R->slot_col.push_back(k);
            R->slot_step.push_back(k);
            next_slot++;
        }
        for (i64 J : step_cols[k]) {
            u_slot_of[k].push_back(next_slot);
            R->u_slots.push_back(next_slot);
            R->slot_row.push_back(k);
            R->slot_col.push_back(J);
            R->slot_step.push_back(k);
            next_slot++;
        }
        R->l_ptr[k + 1] = (i64)R->l_slots.size();
        R->u_ptr[k + 1] = (i64)R->u_slots.size();
    }

    // slot lookup for gemm targets: key (I,J) -> slot, via per-column maps
    // target (I,J): if I>J it is L slot of step J at position of I in
    // step_rows[J]; if I<J, U slot of step I; if I==J, diag.
    auto slot_of = [&](i64 I, i64 J) -> i64 {
        if (I == J) return R->diag_slot[I];
        if (I > J) {
            const auto& v = step_rows[J];
            size_t p = std::lower_bound(v.begin(), v.end(), I) - v.begin();
            return l_slot_of[J][p];
        }
        const auto& v = step_cols[I];
        size_t p = std::lower_bound(v.begin(), v.end(), J) - v.begin();
        return u_slot_of[I][p];
    };

    // gemm tape
    R->g_ptr.assign(nb + 1, 0);
    for (i64 k = 0; k < nb; ++k) {
        const auto& rows = step_rows[k];
        const auto& cols = step_cols[k];
        for (size_t a = 0; a < rows.size(); ++a) {
            for (size_t b = 0; b < cols.size(); ++b) {
                R->g_l.push_back(l_slot_of[k][a]);
                R->g_u.push_back(u_slot_of[k][b]);
                R->g_t.push_back(slot_of(rows[a], cols[b]));
            }
        }
        R->g_ptr[k + 1] = (i64)R->g_l.size();
    }

    // elimination levels + block etree parent
    R->step_level.assign(nb, 0);
    R->block_parent.assign(nb, -1);
    for (i64 j = 0; j < nb; ++j) {
        i64 lv = R->step_level[j] + 1;
        for (i64 I : step_rows[j])
            if (R->step_level[I] < lv) R->step_level[I] = lv;
        for (i64 J : step_cols[j])
            if (R->step_level[J] < lv) R->step_level[J] = lv;
        i64 cand = -1;
        if (!step_rows[j].empty()) cand = step_rows[j][0];
        if (!step_cols[j].empty())
            cand = cand < 0 ? step_cols[j][0]
                            : std::min(cand, step_cols[j][0]);
        R->block_parent[j] = cand;
    }

    // solve schedules
    {
        vector<vector<i64>> dslot(nb), dsrc(nb);
        for (i64 k = 0; k < nb; ++k)
            for (size_t t = 0; t < step_rows[k].size(); ++t) {
                i64 I = step_rows[k][t];
                dslot[I].push_back(l_slot_of[k][t]);
                dsrc[I].push_back(k);
            }
        solve_schedule(nb, dslot, dsrc, true, R->lsol_gptr, R->lsol_gslot,
                       R->lsol_gsrc, R->lsol_gdst, R->lsol_dptr,
                       R->lsol_diag);
    }
    {
        vector<vector<i64>> dslot(nb), dsrc(nb);
        for (i64 k = 0; k < nb; ++k)
            for (size_t t = 0; t < step_cols[k].size(); ++t) {
                dslot[k].push_back(u_slot_of[k][t]);
                dsrc[k].push_back(step_cols[k][t]);
            }
        solve_schedule(nb, dslot, dsrc, false, R->usol_gptr, R->usol_gslot,
                       R->usol_gsrc, R->usol_gdst, R->usol_dptr,
                       R->usol_diag);
    }
    return R;
}

static vector<i64>* field(SymResult* R, int which) {
    switch (which) {
        case 0: return &R->diag_slot;
        case 1: return &R->l_ptr;
        case 2: return &R->l_slots;
        case 3: return &R->u_ptr;
        case 4: return &R->u_slots;
        case 5: return &R->g_ptr;
        case 6: return &R->g_l;
        case 7: return &R->g_u;
        case 8: return &R->g_t;
        case 9: return &R->slot_row;
        case 10: return &R->slot_col;
        case 11: return &R->slot_step;
        case 12: return &R->step_level;
        case 13: return &R->block_parent;
        case 14: return &R->lsol_gptr;
        case 15: return &R->lsol_gslot;
        case 16: return &R->lsol_gsrc;
        case 17: return &R->lsol_gdst;
        case 18: return &R->lsol_dptr;
        case 19: return &R->lsol_diag;
        case 20: return &R->usol_gptr;
        case 21: return &R->usol_gslot;
        case 22: return &R->usol_gsrc;
        case 23: return &R->usol_gdst;
        case 24: return &R->usol_dptr;
        case 25: return &R->usol_diag;
        default: return nullptr;
    }
}

i64 slu_sym_size(SymResult* R, int which) {
    auto* f = field(R, which);
    return f ? (i64)f->size() : -1;
}

void slu_sym_copy(SymResult* R, int which, i64* out) {
    auto* f = field(R, which);
    if (f && !f->empty()) std::memcpy(out, f->data(), f->size() * 8);
}

void slu_sym_free(SymResult* R) { delete R; }

}  // extern "C"
