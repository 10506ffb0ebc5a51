/* A plain C consumer of the superlu_dist_tpu_torch C ABI.
 *
 *   bridge_solve MATRIX [OPTIONS_JSON [X_OUT]]
 *
 * The pdbridge round trip on a matrix file: read it
 * (slu_tpu_read_matrix), factor it with OPTIONS_JSON (default
 * {"dtype": "float32"}, which factors on the CUDA device; add
 * "device": "cpu" for the CPU), form b = A*1 (slu_tpu_matvec) and solve
 * A x = b with refinement (slu_tpu_solve(h, b, 1, 0, 1)); x is written
 * to X_OUT as n raw doubles when given. Then a 2x2 CSC through
 * slu_tpu_init (factor, logdet, refined solve, each checked). Prints
 *   CBRIDGE OK n=<n> maxerr=<max |x - 1|> read_s=.. factor_s=.. solve_s=..
 * (the seconds of the first read, factor and solve calls of the process:
 * the first starts the interpreter, the first factor imports torch) and
 * exits 0 only if maxerr < 1e-4.
 *
 * Build: superlu_dist_tpu_torch.utils.cbridge.compile_program. */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#include "superlu_dist_tpu_torch.h"

static double now(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

static int tiny(const char *opts) {
    int64_t colptr[3] = {0, 1, 2};
    int64_t rowind[2] = {0, 1};
    double vals[2] = {2.0, 4.0};
    int64_t h = slu_tpu_init(2, colptr, rowind, vals, NULL, 2);
    if (!h) { fprintf(stderr, "init: %s\n", slu_tpu_last_error()); return 1; }
    if (slu_tpu_factor(h, opts) != 0) {
        fprintf(stderr, "factor: %s\n", slu_tpu_last_error()); return 1;
    }
    double sr, si, la;
    if (slu_tpu_logdet(h, &sr, &si, &la) != 0) {
        fprintf(stderr, "logdet: %s\n", slu_tpu_last_error()); return 1;
    }
    if (fabs(la - log(8.0)) > 1e-5 || fabs(sr - 1.0) > 1e-5) {
        fprintf(stderr, "logdet wrong: %g %g\n", sr, la); return 1;
    }
    double b[2] = {2.0, 8.0};
    if (slu_tpu_solve(h, b, 1, 0, 1) != 0) {
        fprintf(stderr, "solve: %s\n", slu_tpu_last_error()); return 1;
    }
    if (fabs(b[0] - 1.0) > 1e-5 || fabs(b[1] - 2.0) > 1e-5) {
        fprintf(stderr, "tiny solve wrong: %g %g\n", b[0], b[1]); return 1;
    }
    slu_tpu_free(h);
    return 0;
}

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s matrix [options_json [x_out]]\n", argv[0]);
        return 2;
    }
    const char *opts = argc > 2 ? argv[2] : "{\"dtype\": \"float32\"}";

    double t0 = now();
    int64_t h = slu_tpu_read_matrix(argv[1]);
    if (!h) { fprintf(stderr, "read: %s\n", slu_tpu_last_error()); return 1; }
    double t_read = now() - t0;
    int64_t n = slu_tpu_n(h);
    if (n <= 0) { fprintf(stderr, "n: %s\n", slu_tpu_last_error()); return 1; }

    t0 = now();
    int info = slu_tpu_factor(h, opts);
    double t_factor = now() - t0;
    if (info != 0) {
        fprintf(stderr, "factor info=%d: %s\n", info, slu_tpu_last_error());
        return 1;
    }

    double *ones = (double *)malloc(n * sizeof(double));
    double *b = (double *)malloc(n * sizeof(double));
    for (int64_t i = 0; i < n; ++i) ones[i] = 1.0;
    if (slu_tpu_matvec(h, ones, b) != 0) {
        fprintf(stderr, "matvec: %s\n", slu_tpu_last_error()); return 1;
    }
    t0 = now();
    if (slu_tpu_solve(h, b, 1, 0, 1) != 0) {
        fprintf(stderr, "solve: %s\n", slu_tpu_last_error()); return 1;
    }
    double t_solve = now() - t0;
    double maxerr = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double e = fabs(b[i] - 1.0);
        if (e > maxerr) maxerr = e;
    }
    if (argc > 3) {
        FILE *f = fopen(argv[3], "wb");
        if (!f || fwrite(b, sizeof(double), n, f) != (size_t)n) {
            fprintf(stderr, "cannot write %s\n", argv[3]); return 1;
        }
        fclose(f);
    }
    slu_tpu_free(h);
    free(ones);
    free(b);
    if (tiny(opts)) return 1;
    printf("CBRIDGE OK n=%lld maxerr=%.3e read_s=%.3f factor_s=%.3f "
           "solve_s=%.3f\n", (long long)n, maxerr, t_read, t_factor,
           t_solve);
    return maxerr < 1e-4 ? 0 : 1;
}
