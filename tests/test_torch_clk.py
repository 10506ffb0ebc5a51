"""Kernel 2 (clk): the plain level-by-level clk factor and the plain
right-looking ``factor_plain`` against the JAX package's clk kernel (in
interpret mode) and its float64 XLA executor, on the cases of
tests/test_clk.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from superlu_dist_tpu.ops.host.symbolic import block_symbolic as jsym
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import clk as jclk

from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.ops.kernels import clk
from superlu_dist_tpu_torch.utils.testing import laplacian_2d, laplacian_3d

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


def jax_f64_truth(A, plan):
    """Reference factors via the JAX package's float64 XLA executor."""
    pool0 = jbl.init_pool(plan, A.data.astype(np.float64), np.float64)
    fn = jbl.build_factor_fn(plan, chunk=8)
    p, li, ui, _ = fn(jnp.array(pool0), jnp.asarray(0.0, jnp.float64),
                      jbl.make_factor_tapes(plan))
    return np.asarray(p), np.asarray(li), np.asarray(ui)


def jax_clk(A, plan):
    pool0 = jbl.init_pool(plan, A.data, np.float32)
    fn, tapes = jclk.build_factor_fn_clk(plan, interpret=True)
    p, li, ui, tiny = fn(jnp.array(pool0), jnp.asarray(0.0, jnp.float32),
                         tapes)
    return np.asarray(p), np.asarray(li), np.asarray(ui), int(tiny)


def port_factors(A, plan):
    """(plain clk factor, plain right-looking factor), both float32."""
    tp = clk.build_clk_tapes(plan, "cpu")
    p = tbl.init_pool(plan, A.data, np.float32, "cpu")
    c = clk.factor(p, 0.0, tp, plan.nb)
    r = tbl.factor_plain(plan, tbl.init_pool(plan, A.data, np.float32,
                                             "cpu"), 0.0)
    return c, r


def check(A, bs, ulps):
    A = A.tocsc().astype(np.float32)
    plan = block_symbolic(A, bs)
    ns, nb = plan.nslots, plan.nb
    p64, li64, ui64 = jax_f64_truth(A, jsym(A, bs))
    pj, lij, _, tj = jax_clk(A, jsym(A, bs))
    (pc, lic, uic, tc), (pr, lir, uir, tr) = port_factors(A, plan)
    assert int(tc) == tr == tj == 0
    scale = max(np.abs(p64[:ns]).max(), 1.0)
    tol = ulps * EPS32 * scale
    for pool in (pc, pr):
        assert np.abs(pool[:ns].numpy() - p64[:ns]).max() < tol
        assert np.abs(pool[:ns].numpy() - pj[:ns]).max() < 2 * tol
    ltol = ulps * EPS32 * max(np.abs(li64[:nb]).max(), 1.0)
    for li in (lic, lir):
        assert np.abs(li.numpy() - li64[:nb]).max() < ltol
        assert np.abs(li.numpy() - lij[:nb]).max() < 2 * ltol
    utol = ulps * EPS32 * max(np.abs(ui64[:nb]).max(), 1.0)
    for ui in (uic, uir):
        assert np.abs(ui.numpy() - ui64[:nb]).max() < utol


@pytest.mark.parametrize("mat,bs", [("lap2d12", 16), ("lap3d8", 32),
                                    ("lap2d20", 8)])
def test_clk_matches_jax(mat, bs):
    """64 ulp at the pool scale against the float64 truth (the tolerance
    of tests/test_clk.py), twice that against the JAX float32 clk."""
    A = {"lap2d12": laplacian_2d(12), "lap3d8": laplacian_3d(8),
         "lap2d20": laplacian_2d(20)}[mat]
    check(A, bs, 64)


@pytest.mark.parametrize("trial", range(5))
def test_clk_random_patterns(trial):
    """Random sparse patterns stress the pair schedule and the fill
    closure's target map; 512 ulp as in tests/test_clk.py."""
    rng = np.random.default_rng(7)
    for _ in range(trial + 1):
        n = 160
        d = rng.uniform(0.02, 0.08)
        M = sp.random(n, n, density=d, random_state=rng.integers(1 << 30),
                      format="csc")
    A = M + M.T + sp.eye(n) * (n * 0.5)
    check(A, 16, 512)


def test_clk_refuses_ilu_plan():
    """ILU plans drop fill, which breaks the closure clk relies on."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, 8, ilu_level=0)
    assert plan.nslots < block_symbolic(A, 8).nslots
    with pytest.raises(ValueError):
        clk.build_clk_tapes(plan, "cpu")


def test_clk_tapes_cover_every_schur_triple():
    """Every Schur triple of the plan is exactly one (job, L block) pair
    of the left-looking tapes, with the same target slot."""
    A = laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 16)
    tp = clk.build_clk_tapes(plan, "cpu")
    h = tp.host
    pairs = set()
    for q in range(len(h["job_src"])):
        uslot = None
        for k in range(plan.nb):
            if h["col_job0"][k] <= q < h["col_job0"][k] + h["col_dpos"][k]:
                uslot = h["col_base"][k] + q - h["col_job0"][k]
        for m in range(h["job_lm"][q]):
            pairs.add((int(h["job_la0"][q] + m), int(uslot),
                       int(h["dst"][h["job_dst0"][q] + m])))
    triples = set(zip(plan.g_l.tolist(), plan.g_u.tolist(),
                      plan.g_t.tolist()))
    assert pairs == triples
