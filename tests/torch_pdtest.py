"""The pdtest configuration runner for the port (reference:
TEST/pdtest.c:107-563), shared by ``tests/test_torch_pdtest.py`` (CPU,
beside the JAX package) and the card copy of its single-device leg in
``tests/test_torch_cuda.py``; it imports no JAX, so the card machine can
run it."""

import numpy as np

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.utils.testing import compute_resid

FACTS = [T.Fact.DOFACT, T.Fact.SAME_PATTERN,
         T.Fact.SAME_PATTERN_SAME_ROWPERM, T.Fact.FACTORED]
NRHS = [1, 3]


def perturbed(A, seed):
    rng = np.random.default_rng(seed)
    B = A.copy()
    B.data = B.data * (1.0 + 0.05 * rng.standard_normal(A.nnz))
    return B


def rhs(A, nrhs, trans=False):
    """The config's right-hand sides from the true solution of seed 42."""
    xt = np.random.default_rng(42).standard_normal((A.shape[0], nrhs))
    return xt, np.asarray((A.T if trans else A) @ xt)


def run_config(gssvx, A, opts, fact, nrhs, **kw):
    """One pdtest config through ``gssvx(A, b, opts, lu=...)`` (either
    package's single-device driver): stage the reuse modes from a prior
    factorization (pdtest.c:231-247) and solve. Returns (result, the
    worst residual test value over the right-hand sides)."""
    _, b = rhs(A, nrhs)
    if fact == T.Fact.DOFACT:
        res, _ = gssvx(A, b, opts, **kw)
    elif fact == T.Fact.FACTORED:
        _, lu = gssvx(A, b, opts, **kw)
        res, _ = gssvx(A, b, opts.replace(fact=fact), lu=lu, **kw)
    else:
        # stage: factor a same-pattern different-value matrix first
        _, lu = gssvx(perturbed(A, 7), b, opts, **kw)
        res, _ = gssvx(A, b, opts.replace(fact=fact), lu=lu, **kw)
    x = res.x if res.x.ndim == 2 else res.x[:, None]
    rt = max(compute_resid(A, x[:, j], b[:, j]) for j in range(nrhs))
    return res, rt


def run_grid_config(A, opts, fact, nrhs, grid, device="cpu"):
    """One pdtest config on a process grid (the pdtest -r/-c analog):
    the reuse modes through ``refactor`` of a prior distributed
    factorization, then a refined solve. Returns (x, berr, residual test
    value)."""
    _, b = rhs(A, nrhs)
    if fact == T.Fact.DOFACT:
        res, _ = T.gssvx_dist(A, b, grid, opts, device=device)
        x, berr = res.x, res.berr
    else:
        _, lu = T.gssvx_dist(A if fact == T.Fact.FACTORED
                             else perturbed(A, 7), b, grid, opts,
                             device=device)
        if fact != T.Fact.FACTORED:
            lu.refactor(A, fact)
        x, berr = lu.refine(b, lu.solve(b))
    x2 = x if x.ndim == 2 else x[:, None]
    rt = max(compute_resid(A, x2[:, j], b[:, j]) for j in range(nrhs))
    return x, berr, rt
