/* superlu_dist_tpu_torch C ABI — the pdbridge analog.
 *
 * A plain-C handle API over the PyTorch/CUDA sparse direct solver, so
 * C/C++/Fortran hosts can factor and solve without touching Python
 * (reference: PYTHON/pdbridge.h:27-37 — pdbridge_init / factor / solve /
 * logdet / free). The implementation (bridge.cpp) embeds CPython and
 * drives the library's SparseLU; build it with
 * `python -c "from superlu_dist_tpu_torch.utils.cbridge import build_bridge;
 *             print(build_bridge())"`
 * and run the host program with PYTHONPATH naming the checkout and the
 * site-packages that hold torch. The symbols are the slu_tpu_* set that
 * bindings/superlu_tpu_mod.f90 binds.
 *
 * A handle factors on the CUDA device unless its options JSON holds
 * "device": "cpu"; without a CUDA device slu_tpu_factor returns -1.
 *
 * All functions return 0 on success unless documented otherwise; on any
 * failure consult slu_tpu_last_error().
 */
#ifndef SUPERLU_DIST_TPU_TORCH_H
#define SUPERLU_DIST_TPU_TORCH_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Register an n x n CSC matrix; returns a positive handle, 0 on error.
 * colptr: n+1 entries; rowind/nzval_re[/nzval_im]: nnz entries.
 * nzval_im may be NULL for real matrices. Arrays are copied. */
int64_t slu_tpu_init(int64_t n, const int64_t *colptr,
                     const int64_t *rowind, const double *nzval_re,
                     const double *nzval_im, int64_t nnz);

/* Load a Harwell-Boeing / Rutherford-Boeing / MatrixMarket file into a
 * fresh handle (the dcreate_matrix role). Returns handle or 0. */
int64_t slu_tpu_read_matrix(const char *path);

/* Matrix dimension of a handle (-1 on error). */
int64_t slu_tpu_n(int64_t handle);

/* Factor: full gssvx preprocessing + numeric factorization.
 * options_json: JSON of Options fields (e.g. "{\"dtype\":\"float32\"}"),
 * may be NULL/empty for defaults; "device": "cpu" factors on the CPU.
 * Returns 0, a positive 1-based singular-pivot index (the pdgstrf info
 * contract), or -1 on error. */
int32_t slu_tpu_factor(int64_t handle, const char *options_json);

/* Solve in place: b holds nrhs right-hand sides of length n, each
 * contiguous (column-major as in the reference drivers); overwritten
 * with the solution. trans: 0 = A x = b, 1 = A^T x = b, 2 = A^H x = b.
 * refine != 0 runs iterative refinement (trans 0 only). */
int32_t slu_tpu_solve(int64_t handle, double *b, int64_t nrhs,
                      int32_t trans, int32_t refine);

/* out = A @ x (residual checks from the C side). */
int32_t slu_tpu_matvec(int64_t handle, const double *x, double *out);

/* log|det(A)| and its sign/phase (pdGetDiagU analog). */
int32_t slu_tpu_logdet(int64_t handle, double *sign_re, double *sign_im,
                       double *logabs);

/* Release a handle (idempotent). */
void slu_tpu_free(int64_t handle);

/* Last error message for this process ("" if none). */
const char *slu_tpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* SUPERLU_DIST_TPU_TORCH_H */
