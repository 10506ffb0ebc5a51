"""Kernels 6–8 (schur, trsm): the port's plain level-by-level executor
against the JAX package's Pallas level executor (in interpret mode) and
its float64 XLA executor, on the fixtures of tests/test_pallas.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from superlu_dist_tpu.ops.host.symbolic import block_symbolic as jsym
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import pallas_exec as jpe

from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.ops.kernels import schur
from superlu_dist_tpu_torch.utils.testing import (laplacian_3d,
                                                  laplacian_arrowhead)

torch.set_num_threads(2)
THRESH = 1e-6


def adversarial(seed, n=1280):
    """tests/test_pallas.py's random pattern with many duplicate Schur
    targets per level."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=0.01, random_state=rng.integers(1 << 30),
                  format="csc")
    return sp.csc_matrix(M + M.T + sp.eye(n) * (3.0 * n))


def jax_xla(A, plan, dtype):
    pool0 = jbl.init_pool(plan, A.data.astype(dtype), dtype)
    fn = jbl.build_factor_fn(plan, chunk=16)
    p, _, _, _ = fn(jnp.array(pool0), jnp.asarray(THRESH, dtype),
                    jbl.make_factor_tapes(plan))
    return np.asarray(p)


def port_level(A, plan):
    tp = schur.build_level_tapes(plan, "cpu")
    pool = tbl.init_pool(plan, A.data, np.float32, "cpu")
    return schur.factor(pool, THRESH, tp, plan.nb)


def assert_f32_close_to_truth(pf32, truth, nre, ref_err, ulps=64):
    """tests/test_pallas.py's rule: per block, 64 float32 ulp at the pool
    scale plus 8x the XLA f32 executor's own error on that block."""
    scale = max(1.0, float(np.abs(truth[:nre]).max()))
    tol = ulps * np.finfo(np.float32).eps * scale
    d = np.abs(np.asarray(pf32)[:nre] - truth[:nre]).max(axis=(1, 2))
    bad = d > tol + 8.0 * ref_err
    assert not bad.any(), f"{bad.sum()} blocks off; worst {d[bad].max()}"


def check(A):
    A = A.tocsc().astype(np.float32)
    plan, jplan = block_symbolic(A, 128), jsym(A, 128)
    assert plan.nslots == jplan.nslots
    ns = plan.nslots
    truth = jax_xla(A, jplan, np.float64)
    ref_err = np.abs(jax_xla(A, jplan, np.float32)[:ns]
                     - truth[:ns]).max(axis=(1, 2))
    pt = port_level(A, plan)[0].numpy()
    assert_f32_close_to_truth(pt, truth, ns, ref_err)
    fn, tapes = jpe.build_factor_fn_pallas(jplan, chunk=4, interpret=True)
    pj = np.asarray(fn(jnp.array(jbl.init_pool(jplan, A.data, np.float32)),
                       jnp.float32(THRESH), tapes)[0])
    assert_f32_close_to_truth(pj, truth, ns, ref_err)
    # against the JAX float32 kernel: twice the allowance of each side
    assert_f32_close_to_truth(pt, pj, ns, 2 * ref_err, ulps=128)
    return plan


def test_level_executor_bushy_matches_jax():
    plan = check(laplacian_arrowhead())   # tests/test_pallas.py's bushy
    assert plan.n_flevels < plan.nb, "needs several steps per level"


def test_level_executor_adversarial_matches_jax():
    check(adversarial(11))


@pytest.mark.parametrize("ilu", [None, 0, 1])
def test_level_executor_equals_right_looking_plain(ilu):
    """At block size 16 (lap3d8, exact and ILU plans) the per-phase plain
    pieces compose to ``blocklu.factor_plain``'s factor exactly: the
    same products, summed in the same order."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, 16, ilu_level=ilu)
    tp = schur.build_level_tapes(plan, "cpu")
    got = schur.factor(tbl.init_pool(plan, A.data, np.float32, "cpu"), 0.0,
                       tp, plan.nb)
    ref = tbl.factor_plain(plan, tbl.init_pool(plan, A.data, np.float32,
                                               "cpu"), 0.0)
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    assert int(got[3]) == ref[3] == 0


@pytest.mark.parametrize("tri", [False, True], ids=["full", "tri"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64],
                         ids=["f64", "f32", "c128", "c64"])
@pytest.mark.parametrize("left", [False, True])
def test_trsm_plain(left, dtype, tri):
    """``trsm`` on the CPU against one product per panel. ``tri``: the
    inverses are triangular as diag_lu leaves them (linv lower for U
    panels, uinv upper for L panels) and steps repeat, as in a level of
    the tapes. The complex types' imaginary parts are drawn after the
    real parts."""
    rng = np.random.default_rng(3)
    pool = torch.as_tensor(rng.standard_normal((6, 8, 8)), dtype=dtype)
    dinv = torch.as_tensor(rng.standard_normal((3, 8, 8)), dtype=dtype)
    if dtype.is_complex:
        pool += 1j * torch.as_tensor(rng.standard_normal((6, 8, 8)),
                                     dtype=dtype)
        dinv += 1j * torch.as_tensor(rng.standard_normal((3, 8, 8)),
                                     dtype=dtype)
    slots, steps = [4, 1, 2], [2, 0, 2]
    if tri:
        dinv = torch.tril(dinv) if left else torch.triu(dinv)
        slots, steps = [4, 1, 2, 5, 0], [2, 0, 2, 2, 0]
    want = pool.clone()
    for s, k in zip(slots, steps):
        want[s] = dinv[k] @ pool[s] if left else pool[s] @ dinv[k]
    schur.trsm(pool, dinv, torch.tensor(slots, dtype=torch.int32),
               torch.tensor(steps, dtype=torch.int32), left)
    tol = 1e-14 if dtype in (torch.float64, torch.complex128) else 1e-5
    assert torch.allclose(pool, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mat", ["bushy", "lap3d8"])
def test_level_tapes_group_each_level_by_target(mat):
    """Each level's triples sit under their target, once each; a target
    of level l is owned by a step of a higher level, so it is never an L
    or U panel of level l."""
    A = laplacian_arrowhead() if mat == "bushy" else laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 128 if mat == "bushy" else 16)
    tp = schur.build_level_tapes(plan, "cpu")
    h = tp.host
    lev = np.asarray(plan.step_level)
    owner = np.minimum(plan.slot_row, plan.slot_col)
    dst = np.repeat(h["tslot"], np.diff(h["cptr"]))
    pairs = sorted(zip(h["cl"].tolist(), h["cu"].tolist(), dst.tolist()))
    assert pairs == sorted(zip(plan.g_l.tolist(), plan.g_u.tolist(),
                               plan.g_t.tolist()))
    for l in range(tp.nlvl):
        t = h["tslot"][tp.sptr[l]:tp.sptr[l + 1]]
        assert len(np.unique(t)) == len(t)
        assert np.all(lev[owner[t]] > l)
        c = slice(h["cptr"][tp.sptr[l]], h["cptr"][tp.sptr[l + 1]])
        assert np.all(lev[owner[h["cl"][c]]] == l)
        panels = np.r_[h["lslot"][tp.lptr[l]:tp.lptr[l + 1]],
                       h["uslot"][tp.uptr[l]:tp.uptr[l + 1]]]
        assert not np.intersect1d(t, panels).size
