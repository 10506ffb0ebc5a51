"""The pdtest cross-product through the port (reference:
TEST/pdtest.c:107-563): the legs of ``tests/test_pdtest_sweep.py`` run by
``superlu_dist_tpu_torch`` on the CPU, each config accepted iff its
residual test value is below THRESH = 20 (TEST/pdtest.c:44) and berr
below 1e-10.

- single device: equil × rowperm × fact (with the reuse staging of
  pdtest.c:231-247) × nrhs ∈ {1, 3}, float32, bs 16;
- the 2×4 grid: fact × nrhs at the default equil and rowperm;
- the grid's TRANS leg: ``Options.trans`` through ``gssvx_dist``;
- the complex leg skips without the reference's ``cg20.cua``, as the
  reference's own does.

The two NOROWPERM cells are held to the reference's output, not to
THRESH: the fallback matrix ``unsymmetric_pattern(120, seed=3)`` (the
reference's ``g20.rua`` is absent here) has a diagonal of about 1e-3,
so without row matching the factor replaces tiny pivots and the
reference's own solution fails the residual test (ROADMAP.md queue 3:
its ``test_pdtest_cross_product_single[*-NOROWPERM]`` fail in every
run). There the port must replace as many pivots as the reference, take
as many refinement steps, and miss THRESH as the reference does: a
residual test value within a factor of two of the reference's and a
berr within 1% of it."""

import itertools

import numpy as np
import pytest

import superlu_dist_tpu as J
from superlu_dist_tpu.utils.testing import reference_matrix
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.utils.testing import (THRESH, compute_resid,
                                                  unsymmetric_pattern)
from torch_pdtest import FACTS, NRHS, rhs, run_config, run_grid_config


def _matrix():
    g20 = reference_matrix("g20.rua")
    return g20 if g20 is not None else unsymmetric_pattern(120, seed=3)


A_BASE = _matrix()
EQUILS = [T.Equil.YES, T.Equil.NO]
ROWPERMS = [T.RowPerm.NOROWPERM, T.RowPerm.LARGE_DIAG_MC64]


def _jax_opts(opts):
    """The JAX package's Options equal to the port's ``opts``."""
    return J.Options(dtype=opts.dtype, block_size=opts.block_size,
                     equil=getattr(J.Equil, opts.equil.name),
                     row_perm=getattr(J.RowPerm, opts.row_perm.name))


@pytest.mark.parametrize("equil,rowperm",
                         list(itertools.product(EQUILS, ROWPERMS)))
def test_pdtest_cross_product_single(equil, rowperm):
    """Single-device leg: {fact incl. staging} × {nrhs} in each
    {equil} × {rowperm} cell."""
    for fact, nrhs in itertools.product(FACTS, NRHS):
        opts = T.Options(dtype="float32", block_size=16, equil=equil,
                         row_perm=rowperm)
        res, rt = run_config(T.gssvx, A_BASE, opts, fact, nrhs,
                             device="cpu")
        what = f"fact={fact} equil={equil} rowperm={rowperm} nrhs={nrhs}"
        if rowperm != T.RowPerm.NOROWPERM:
            assert rt < THRESH, f"residual test {rt:.2f} for {what}"
            assert float(np.max(res.berr)) < 1e-10, what
            continue
        jres, jrt = run_config(J.gssvx, A_BASE, _jax_opts(opts),
                               getattr(J.Fact, fact.name), nrhs)
        # FACTORED factors nothing in its own call, so counts none
        assert res.stat.tiny_pivots == jres.stat.tiny_pivots, what
        assert jres.stat.tiny_pivots > 0 or fact == T.Fact.FACTORED, what
        assert res.stat.refine_steps == jres.stat.refine_steps, what
        assert (rt >= THRESH) == (jrt >= THRESH), what
        assert jrt / 2 <= rt <= 2 * jrt, (what, rt, jrt)
        berr, jberr = float(np.max(res.berr)), float(np.max(jres.berr))
        assert abs(berr - jberr) <= 0.01 * jberr, (what, berr, jberr)


@pytest.mark.parametrize("fact", FACTS)
def test_pdtest_cross_product_dist(fact):
    """Distributed leg (the grid axis coarsened to one 2×4 grid, the
    pdtest -r/-c analog): {fact} × {nrhs} at the default equil and
    rowperm (one right-hand side for the reuse modes, as the reference's
    leg)."""
    nrhs_set = NRHS if fact == T.Fact.DOFACT else [1]
    for nrhs in nrhs_set:
        opts = T.Options(dtype="float32", block_size=16)
        _, berr, rt = run_grid_config(A_BASE, opts, fact, nrhs,
                                      T.Grid2D(2, 4))
        assert rt < THRESH, f"residual test {rt:.2f} for {fact} {nrhs}"
        assert float(np.max(berr)) < 1e-10


def test_options_trans_dist_driver():
    """``Options.trans`` through ``gssvx_dist``: the solve, the refinement
    residuals and berr in Aᵀ (the options->Trans contract,
    superlu_defs.h:684-728)."""
    xt, b = rhs(A_BASE, 1, trans=True)
    res, _ = T.gssvx_dist(A_BASE, b[:, 0], T.Grid2D(2, 4), T.Options(
        dtype="float32", block_size=16, trans=T.Trans.TRANS), device="cpu")
    assert np.abs(res.x - xt[:, 0]).max() / np.abs(xt).max() < 1e-8
    assert float(np.max(res.berr)) < 1e-10
    assert compute_resid(A_BASE.T, res.x, b[:, 0]) < THRESH


def test_pdtest_complex_axis():
    """pztest leg: the fact-staging sweep on the complex fixture
    (reference: TEST/pztest.c)."""
    C = reference_matrix("cg20.cua")
    if C is None:
        pytest.skip("complex fixture not available")
    opts = T.Options(dtype="complex128", block_size=16)
    for fact in FACTS:
        res, rt = run_config(T.gssvx, C, opts, fact, 1, device="cpu")
        assert rt < THRESH and float(np.max(res.berr)) < 1e-10
