"""Kernel 4 (flk): the port's plain level-by-level flk factor against the
JAX package's flk kernel (in interpret mode) and its float64 XLA
executor, on exact-LU and ILU(k) plans, and the tiny-pivot count of
tests/test_flk.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from superlu_dist_tpu.ops.host.symbolic import block_symbolic as jsym
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import flk as jflk

from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.ops.kernels import diag_lu, flk
from superlu_dist_tpu_torch.utils.testing import laplacian_2d, laplacian_3d

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


def jax_f64_truth(A, plan, thresh=0.0):
    """Reference factors via the JAX package's float64 XLA executor."""
    pool0 = jbl.init_pool(plan, A.data.astype(np.float64), np.float64)
    fn = jbl.build_factor_fn(plan, chunk=8)
    p, li, ui, tiny = fn(jnp.array(pool0), jnp.asarray(thresh, jnp.float64),
                         jbl.make_factor_tapes(plan))
    return np.asarray(p), np.asarray(li), np.asarray(ui), int(tiny)


def jax_flk(A, plan, thresh=0.0):
    pool0 = jbl.init_pool(plan, A.data, np.float32)
    fn, tapes = jflk.build_factor_fn_flk(plan, interpret=True)
    p, li, ui, tiny = fn(jnp.array(pool0), jnp.asarray(thresh, jnp.float32),
                         tapes)
    return np.asarray(p), np.asarray(li), np.asarray(ui), int(tiny)


def port_flk(A, plan, thresh=0.0, chunk=None):
    """The port's flk factor on the CPU: ``flk.factor`` (the plain
    version), or with ``chunk`` the two passes' plain version over the
    tapes' chunks of at most ``chunk`` products."""
    tp = flk.build_flk_tapes(plan, "cpu", chunk=chunk)
    pool = tbl.init_pool(plan, A.data, np.float32, "cpu")
    if chunk is None:
        p, li, ui, tiny = flk.factor(pool, thresh, tp, plan.nb)
        return p.numpy(), li.numpy(), ui.numpy(), int(tiny)
    bs, nb = plan.bs, plan.nb
    li = torch.zeros((nb, bs, bs))
    ui = torch.zeros_like(li)
    tiny = torch.zeros(1, dtype=torch.int32)
    for lvl in range(tp.nlvl):
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        flk.flk_update_chunks_plain(pool, li, ui, tp, 2 * lvl)
        diag_lu.diag_lu(pool, li, ui, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        thresh, tiny)
        flk.flk_update_chunks_plain(pool, li, ui, tp, 2 * lvl + 1)
    return pool.numpy(), li.numpy(), ui.numpy(), int(tiny)


def check(A, bs, ulps, ilu=None, chunk=None):
    A = A.tocsc().astype(np.float32)
    plan = block_symbolic(A, bs, ilu_level=ilu)
    jplan = jsym(A, bs, ilu_level=ilu)
    assert plan.nslots == jplan.nslots
    ns, nb = plan.nslots, plan.nb
    p64, li64, ui64, _ = jax_f64_truth(A, jplan)
    pj, lij, uij, tj = jax_flk(A, jplan)
    pt, lit, uit, tt = port_flk(A, plan, chunk=chunk)
    assert tt == tj == 0
    for got, truth, jax32, rows in ((pt, p64, pj, ns), (lit, li64, lij, nb),
                                    (uit, ui64, uij, nb)):
        tol = ulps * EPS32 * max(np.abs(truth[:rows]).max(), 1.0)
        assert np.abs(got[:rows] - truth[:rows]).max() < tol
        assert np.abs(got[:rows] - jax32[:rows]).max() < 2 * tol


@pytest.mark.parametrize("mat,bs", [("lap2d12", 16), ("lap3d8", 32)])
def test_flk_matches_jax(mat, bs):
    """64 ulp at the pool scale against the float64 truth (the tolerance
    of tests/test_clk.py), twice that against the JAX float32 flk."""
    A = {"lap2d12": laplacian_2d(12), "lap3d8": laplacian_3d(8)}[mat]
    check(A, bs, 64)


@pytest.mark.parametrize("ilu", [0, 1])
def test_flk_ilu_matches_jax(ilu):
    """ILU(k) plans drop fill: flk sums only the triples into stored
    blocks, as the JAX flk and the XLA executor do."""
    A = laplacian_3d(8)
    assert block_symbolic(A.tocsc(), 16, ilu_level=ilu).nslots \
        < block_symbolic(A.tocsc(), 16).nslots
    check(A, 16, 64, ilu=ilu)


@pytest.mark.parametrize("chunk", [1, 3])
def test_flk_chunked_matches_jax(chunk):
    """The card's two passes in plain PyTorch on chunks of one and of
    three products (partial sums in scratch rows, then added in chunk
    order and finalized), on an ILU(1) plan: the tolerance of
    test_flk_ilu_matches_jax."""
    check(laplacian_3d(8), 16, 64, ilu=1, chunk=chunk)


@pytest.mark.parametrize("trial", range(5))
def test_flk_random_patterns(trial):
    """Random sparse patterns; 512 ulp as in tests/test_clk.py."""
    rng = np.random.default_rng(7)
    for _ in range(trial + 1):
        n = 160
        d = rng.uniform(0.02, 0.08)
        M = sp.random(n, n, density=d, random_state=rng.integers(1 << 30),
                      format="csc")
    A = M + M.T + sp.eye(n) * (n * 0.5)
    check(A, 16, 512)


def test_flk_tiny_pivot_count():
    """An exactly-zero pivot is replaced and counted, as by the JAX flk
    and the XLA executor (tests/test_flk.py)."""
    n = 256
    A = sp.csc_matrix((np.where(np.arange(n) == 5, 0.0, 1.0),
                       (np.arange(n), np.arange(n))), shape=(n, n))
    A32 = A.astype(np.float32)
    plan, jplan = block_symbolic(A32, 128), jsym(A32, 128)
    _, _, _, tx = jax_f64_truth(A32, jplan, 1e-3)
    _, _, _, tj = jax_flk(A32, jplan, 1e-3)
    _, _, _, tt = port_flk(A32, plan, 1e-3)
    assert tt == tj == tx >= 1


@pytest.mark.parametrize("ilu", [None, 1])
def test_flk_tapes_cover_every_block_once(ilu):
    """Every stored block is one flk target, of its owner's level and of
    the right finalize kind; every Schur triple is exactly one
    contribution of its target; and every contribution's sources belong
    to a strictly lower level than the target."""
    A = laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 16, ilu_level=ilu)
    tp = flk.build_flk_tapes(plan, "cpu")
    h = tp.host
    lev = np.asarray(plan.step_level)
    srow, scol = np.asarray(plan.slot_row), np.asarray(plan.slot_col)
    owner = np.minimum(srow, scol)[:plan.nslots]
    diag_has = set(h["dslot"].tolist()) - set(h["tslot"].tolist())
    assert set(h["tslot"].tolist()) | diag_has == set(range(plan.nslots))
    assert len(set(h["tslot"].tolist())) == len(h["tslot"])
    for g in range(2 * tp.nlvl):
        lo, hi = tp.tptr[g], tp.tptr[g + 1]
        s = h["tslot"][lo:hi]
        assert np.all(lev[owner[s]] == g // 2)
        kinds = np.where(srow[s] == scol[s], flk.FIN_NONE,
                         np.where(srow[s] > scol[s], flk.FIN_L, flk.FIN_U))
        assert np.array_equal(kinds, h["tfin"][lo:hi])
        assert np.array_equal(owner[s], h["tstep"][lo:hi])
    dst = np.repeat(h["tslot"], np.diff(h["cptr"]))
    pairs = sorted(zip(h["cl"].tolist(), h["cu"].tolist(), dst.tolist()))
    assert pairs == sorted(zip(plan.g_l.tolist(), plan.g_u.tolist(),
                               plan.g_t.tolist()))
    for src in (h["cl"], h["cu"]):
        assert np.all(lev[owner[src]] < lev[owner[dst]])


@pytest.mark.parametrize("chunk", [None, 1, 3])
@pytest.mark.parametrize("ilu", [None, 1])
def test_flk_chunks_cover_each_chain_once(ilu, chunk):
    """Each target's chain is cut into chunks (at least one) that cover
    its products exactly once, in plan order, within its group's chunk
    range; a target of one chunk finishes in pass 1 (no scratch row), the
    chunks of a target of several take consecutive scratch rows below its
    group's ``nrow``, distinct within the group, and the target is a pass
    2 job of its group with those rows."""
    A = laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 16, ilu_level=ilu)
    tp = flk.build_flk_tapes(plan, "cpu", chunk=chunk)
    h = tp.host
    nq = len(h["qtgt"])
    assert tp.qptr[0] == 0 and tp.qptr[-1] == nq == h["chunkptr"][-1]
    assert len(h["qcptr"]) == nq + 1
    multi = 0
    for g in range(2 * tp.nlvl):
        rows = set()
        m = range(tp.mptr[g], tp.mptr[g + 1])
        for t in range(tp.tptr[g], tp.tptr[g + 1]):
            q0, q1 = h["chunkptr"][t], h["chunkptr"][t + 1]
            assert tp.qptr[g] <= q0 < q1 <= tp.qptr[g + 1]
            assert (h["qtgt"][q0:q1] == t).all()
            prods = [p for q in range(q0, q1)
                     for p in range(h["qcptr"][q], h["qcptr"][q + 1])]
            assert prods == list(range(h["cptr"][t], h["cptr"][t + 1]))
            if chunk:
                assert (np.diff(h["qcptr"][q0:q1 + 1]) <= chunk).all()
            r = h["qrow"][q0:q1]
            if q1 - q0 == 1:
                assert r[0] == -1 and t not in h["mtgt"][m.start:m.stop]
                continue
            multi += 1
            assert (np.diff(r) == 1).all() and 0 <= r[0]
            assert r[-1] < tp.nrow[g] and not rows & set(r.tolist())
            rows |= set(r.tolist())
            j = m.start + int(np.flatnonzero(h["mtgt"][m.start:m.stop]
                                             == t)[0])
            assert h["mrow"][j] == r[0] and h["mcnt"][j] == q1 - q0
        assert len(rows) == tp.nrow[g]
    assert multi == len(h["mtgt"])
    if chunk == 1:
        assert multi > 0
        assert nq == sum(max(1, n) for n in np.diff(h["cptr"]))
