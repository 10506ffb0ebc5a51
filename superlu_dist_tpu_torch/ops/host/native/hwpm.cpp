// Parallel heavy-weight perfect matching (HWPM) via epsilon-scaled
// auction — the reference binds CombBLAS's distributed approximate
// matching for this role (reference: SRC/double/d_c2cpp_GetHWPM.cpp:55,
// dHWPM_CombBLAS.hpp:1-147). Same contract: an APPROXIMATE maximum
// log-product perfect matching, cheaper and parallel where exact MC64 is
// serial; like the reference it returns the permutation only (the HWPM
// path in pdgssvx applies no R1/C1 scalings).
//
// Algorithm: Bertsekas auction with eps-scaling, Jacobi rounds.
//   benefit of row i to column j:  v_ij = log|a_ij|
//   each round, every unassigned column bids (best - second + eps) for
//   its best row at current prices; bids resolve synchronously (highest
//   bid per row wins, previous owner unassigned). Bid computation runs
//   across worker threads; resolution is a serial O(#bids) pass, so
//   rounds are deterministic regardless of thread count.
//
// Near-optimality: with final epsilon e the matching is within n*e of
// the optimum of the sum-of-logs objective (standard auction bound).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Bid {
  int64_t row;
  double val;
};

}  // namespace

extern "C" {

// Ap/Ai: CSC structure (n+1, nnz); absval: |a| per entry (nnz).
// rowperm out (size n): rowperm[j] = row matched to column j.
// Returns 0 on success, -1 if no perfect matching was found (structural
// singularity or price blow-up) — caller falls back to exact MC64.
int64_t slu_hwpm(int64_t n, const int64_t* Ap, const int64_t* Ai,
                 const double* absval, int64_t nthreads,
                 int64_t* rowperm) {
  if (n == 0) return 0;
  const double NEG = -std::numeric_limits<double>::infinity();
  std::vector<double> v(Ap[n]);
  double vmax = NEG, vmin = std::numeric_limits<double>::infinity();
  for (int64_t e = 0; e < Ap[n]; ++e) {
    v[e] = absval[e] > 0 ? std::log(absval[e]) : NEG;
    if (v[e] != NEG) {
      if (v[e] > vmax) vmax = v[e];
      if (v[e] < vmin) vmin = v[e];
    }
  }
  if (vmax == NEG) return -1;
  const double range = (vmax > vmin) ? (vmax - vmin) : 1.0;

  std::vector<double> price(n, 0.0);
  std::vector<int64_t> owner(n, -1);   // row -> column
  std::vector<int64_t> match(n, -1);   // column -> row
  std::vector<Bid> bids(n);
  std::vector<int64_t> unassigned(n), next_unassigned;
  next_unassigned.reserve(n);

  int64_t nt = nthreads > 0 ? nthreads
                            : (int64_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 32) nt = 32;

  const double price_cap = (range + 1.0) * (double)(n + 1) * 4.0;

  // eps-scaling phases: coarse to fine
  double eps = range / 4.0;
  if (eps <= 0) eps = 1.0;
  const double eps_final = range * 1e-6 / (double)(n + 1) + 1e-12;

  for (;; eps /= 8.0) {
    if (eps < eps_final) eps = eps_final;
    // unassign everything for this phase (prices persist)
    std::fill(owner.begin(), owner.end(), -1);
    std::fill(match.begin(), match.end(), -1);
    int64_t nun = n;
    for (int64_t j = 0; j < n; ++j) unassigned[j] = j;

    while (nun > 0) {
      // ---- parallel bid computation ----
      auto bid_worker = [&](int64_t lo, int64_t hi) {
        for (int64_t t = lo; t < hi; ++t) {
          int64_t j = unassigned[t];
          double best = NEG, second = NEG;
          int64_t bi = -1;
          for (int64_t e = Ap[j]; e < Ap[j + 1]; ++e) {
            if (v[e] == NEG) continue;
            double w = v[e] - price[Ai[e]];
            if (w > best) {
              second = best;
              best = w;
              bi = Ai[e];
            } else if (w > second) {
              second = w;
            }
          }
          if (bi < 0) {
            bids[j] = {-1, 0.0};
            continue;
          }
          double incr = (second == NEG) ? (range + eps)
                                        : (best - second + eps);
          bids[j] = {bi, price[bi] + incr};
        }
      };
      if (nt == 1 || nun < 256) {
        bid_worker(0, nun);
      } else {
        std::vector<std::thread> ths;
        int64_t chunk = (nun + nt - 1) / nt;
        for (int64_t k = 0; k < nt; ++k) {
          int64_t lo = k * chunk, hi = std::min(nun, lo + chunk);
          if (lo >= hi) break;
          ths.emplace_back(bid_worker, lo, hi);
        }
        for (auto& th : ths) th.join();
      }

      // ---- serial synchronous resolution (deterministic) ----
      next_unassigned.clear();
      bool any = false;
      for (int64_t t = 0; t < nun; ++t) {
        int64_t j = unassigned[t];
        const Bid& b = bids[j];
        if (b.row < 0) return -1;              // isolated column
        if (b.val > price[b.row]) {
          int64_t prev = owner[b.row];
          if (prev >= 0) {
            match[prev] = -1;
            next_unassigned.push_back(prev);
          }
          owner[b.row] = j;
          match[j] = b.row;
          price[b.row] = b.val;
          any = true;
        } else {
          next_unassigned.push_back(j);        // lost a same-round race
        }
      }
      std::swap(unassigned, next_unassigned);
      nun = (int64_t)unassigned.size();
      if (!any && nun > 0) return -1;          // no progress: stuck
      double pmax = 0.0;
      for (int64_t i = 0; i < n; ++i)
        if (price[i] > pmax) pmax = price[i];
      if (pmax > price_cap) return -1;         // structural singularity
    }
    if (eps <= eps_final) break;
  }

  std::memcpy(rowperm, match.data(), sizeof(int64_t) * n);
  return 0;
}

}  // extern "C"
