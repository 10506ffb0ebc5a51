"""The bf16 pass of tck and flk (``gemm_precision``, ROADMAP.md item 2b)
on the CPU: one level of each plain version at "default" against a numpy
oracle that rounds with ml_dtypes, the whole ``gssvx`` through tck, flk
and ILU(1) against the JAX package's, the escalation's re-factor at
"highest", and the ring-embedded complex64 counter against the JAX
package's. tests/test_torch_precision.py holds clk's and the resolution
rule's tests."""

import ml_dtypes
import numpy as np
import pytest
import torch

import superlu_dist_tpu as J

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.models import driver as tdrv
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.kernels import clk, diag_lu, flk, tck
from superlu_dist_tpu_torch.utils import testing as tt

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)
#: one bf16 ulp at 1 (8 significant bits)
EPS_BF16 = 2.0 ** -8


@pytest.fixture
def armed(monkeypatch):
    """"auto" arms the low pass on the CPU, as on CUDA."""
    monkeypatch.setattr(tdrv, "_auto_low_pass", lambda device: True)


def _bf(a):
    """float32 → bf16 (nearest even, ml_dtypes) → float64."""
    return np.asarray(a, dtype=np.float32).astype(
        ml_dtypes.bfloat16).astype(np.float64)


def _matrix():
    """lap3d6 with values that bf16 does not hold exactly (the
    Laplacian's do)."""
    A = tt.laplacian_3d(6).tocsc()
    A.data = A.data * (1.0 + 0.1 * np.random.default_rng(4).standard_normal(
        A.nnz))
    return A


def _setup(executor):
    """A bf16 factor of ``_matrix()`` through ``executor`` at block size
    16, and the pool, inverses and tiny-pivot count before its factor."""
    bs = 16
    lu = T.SparseLU(_matrix(), T.Options(dtype="float32", block_size=bs,
                                         executor=executor,
                                         gemm_precision="bf16"),
                    device="cpu")
    assert lu.executor == executor
    assert lu.stat.counters["gemm_precision"] == "default"
    plan = lu.plan
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cpu")
    linv = torch.zeros((plan.nb, bs, bs))
    return lu, pool, linv, torch.zeros_like(linv), \
        torch.zeros(1, dtype=torch.int32)


def _tol(want):
    """64 float32 ulp of the output's scale: float32 sums against the
    oracle's float64 ones, where rounding another operand, or truncating
    instead of rounding to nearest even, moves a result by about a bf16
    ulp (2^-8)."""
    return 64 * EPS32 * max(1.0, float(np.abs(want).max()))


def _oracle_left_looking(pool, linv, plan, level):
    """The left-looking update of ``level``'s columns at "default" in
    numpy, from the plan alone (clk's reference order, the function that
    tck_update computes): per column, each U(j,k) in ascending j is
    finalized by linv(j), then every L block L(i,j) of column j
    subtracts L(i,j)·U(j,k) from (i,k); each operand rounded by
    ml_dtypes, products and sums in float64, every stored block in
    float32."""
    scol = np.asarray(plan.slot_col, dtype=np.int64)
    srow = np.asarray(plan.slot_row, dtype=np.int64)
    colptr = np.searchsorted(scol, np.arange(plan.nb + 1))
    diag = np.asarray(plan.diag_slot, dtype=np.int64)
    slot = {(int(i), int(k)): s for s, (i, k) in enumerate(zip(srow, scol))}
    for k in np.flatnonzero(np.asarray(plan.step_level) == level):
        for s in range(colptr[k], diag[k]):
            j = int(srow[s])
            U = (_bf(linv[j]) @ _bf(pool[s])).astype(np.float32)
            pool[s] = U
            for ls in range(diag[j] + 1, colptr[j + 1]):
                d = slot[(int(srow[ls]), int(k))]
                pool[d] = (pool[d] - _bf(pool[ls]) @ _bf(U)).astype(
                    np.float32)


def _oracle_flk_group(pool, linv, uinv, plan, tp, group):
    """One flk target group at "default" in numpy: every target of the
    group subtracts its contributions in the plan's order (the plan's
    Schur triples into it), each product's two blocks rounded by
    ml_dtypes, then its finalize on the rounded target and inverse."""
    h = tp.host
    lo, hi = int(tp.tptr[group]), int(tp.tptr[group + 1])
    g_l, g_u, g_t = (np.asarray(a, dtype=np.int64)
                     for a in (plan.g_l, plan.g_u, plan.g_t))
    for t in range(lo, hi):
        s = int(h["tslot"][t])
        T_ = pool[s].astype(np.float64)
        for p in np.flatnonzero(g_t == s):
            T_ = (T_ - _bf(pool[g_l[p]]) @ _bf(pool[g_u[p]])).astype(
                np.float32).astype(np.float64)
        k = int(h["tstep"][t])
        if h["tfin"][t] == flk.FIN_L:
            T_ = _bf(T_) @ _bf(uinv[k])
        elif h["tfin"][t] == flk.FIN_U:
            T_ = _bf(linv[k]) @ _bf(T_)
        pool[s] = T_.astype(np.float32)


def _busiest(counts):
    level = int(np.argmax(counts))
    assert counts[level] > 1
    return level


def test_plain_tck_level_matches_ml_dtypes_oracle():
    """One level of ``tck_update_plain`` at "default" (its input made by
    the levels below at "default") against the numpy oracle, within 64
    float32 ulp of scale, while the FP32 pass lies more than ten times
    that away; its phase A alone holds the level's U blocks to the
    oracle's; the driver's whole bf16 factor is the plain factor at
    "default" bit for bit."""
    lu, pool, linv, uinv, tiny = _setup("tck")
    plan, tp = lu.plan, lu._ftapes
    # the level with the most tiles among those with U blocks
    level = _busiest(np.diff(tp.tptr) * (np.diff(tp.lwave) > 0))
    for lvl in range(level):
        tck.factor_level(pool, linv, uinv, tiny, lu._thresh(), tp, lvl,
                         "default")
    want = pool.numpy().copy()
    _oracle_left_looking(want, linv.numpy(), plan, level)
    got, phase_a, full = pool.clone(), pool.clone(), pool.clone()
    tck.tck_update_plain(got, linv, tp, level, "default")
    tck.tck_waves_plain(phase_a, linv, tp, level, "default")
    tck.tck_update_plain(full, linv, tp, level, "highest")
    tol = _tol(want)
    assert np.abs(got.numpy() - want).max() <= tol
    assert np.abs(full.numpy() - want).max() > 10 * tol
    t0 = int(tp.wptr[tp.lwave[level]])
    t1 = int(tp.wptr[tp.lwave[level + 1]])
    h = tp.host
    us = h["tslot"][t0:t1][h["tfin"][t0:t1] == flk.FIN_U]
    assert len(us)
    assert np.abs(phase_a.numpy()[us] - want[us]).max() <= tol
    pool = got
    for lvl in range(level, tp.nlvl):
        if lvl > level:
            tck.tck_update(pool, linv, tp, lvl, "default")
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        clk.clk_trsm(pool, uinv, tp, lvl, "default")
    assert torch.equal(pool, lu.pool)


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_plain_tck_chains_match_ml_dtypes_oracle(chunk):
    """Every level of the bf16 tck factor's plain version, phase B on its
    positions' chains cut into chunks of ``chunk`` products (None: the
    automatic cut), against the numpy oracle from the same input, within
    64 float32 ulp of scale; the factor goes on with the plain version's
    output, and its diag_lu and TRSM run between the levels."""
    lu, pool, linv, uinv, tiny = _setup("tck")
    plan = lu.plan
    tp = tck.build_tck_tapes(plan, "cpu", chunk=chunk)
    assert len(tp.chains.host["mtgt"]) > 0
    for level in range(tp.nlvl):
        want = pool.numpy().copy()
        _oracle_left_looking(want, linv.numpy(), plan, level)
        tck.tck_update_plain(pool, linv, tp, level, "default")
        assert np.abs(pool.numpy() - want).max() <= _tol(want), level
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        clk.clk_trsm(pool, uinv, tp, level, "default")


def test_plain_flk_level_matches_ml_dtypes_oracle():
    """One level of ``flk_update_plain`` at "default", both its groups
    (the diagonal targets, then the L and U panels with their finalizes),
    against the numpy oracle within 64 float32 ulp of scale, while the
    FP32 pass lies more than ten times that away; the two passes over
    the chunks (``flk_update_chunks_plain``) agree with it as closely;
    the driver's whole bf16 factor is the plain factor at "default" bit
    for bit."""
    lu, pool, linv, uinv, tiny = _setup("flk")
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    # the level whose two groups both hold most targets
    ntgt = np.diff(tp.tptr)
    level = _busiest(np.minimum(ntgt[0::2], ntgt[1::2]))
    for lvl in range(level):
        flk.factor_level(pool, linv, uinv, tiny, th, tp, lvl, "default")
    for g in (2 * level, 2 * level + 1):
        assert tp.tptr[g + 1] > tp.tptr[g]
        want = pool.numpy().copy()
        _oracle_flk_group(want, linv.numpy(), uinv.numpy(), plan, tp, g)
        chunks, full = pool.clone(), pool.clone()
        flk.flk_update_plain(pool, linv, uinv, tp, g, "default")
        flk.flk_update_chunks_plain(chunks, linv, uinv, tp, g, "default")
        flk.flk_update_plain(full, linv, uinv, tp, g, "highest")
        tol = _tol(want)
        assert np.abs(pool.numpy() - want).max() <= tol
        assert float((chunks - pool).abs().max()) <= tol
        assert np.abs(full.numpy() - want).max() > 10 * tol
        if g == 2 * level:
            lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
            diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                            tp.dstep[lo:hi], th, tiny)
    for lvl in range(level + 1, tp.nlvl):
        flk.factor_level(pool, linv, uinv, tiny, th, tp, lvl, "default")
    assert torch.equal(pool, lu.pool)


@pytest.mark.parametrize("kw", [dict(executor="tck"), dict(executor="flk")],
                         ids=["tck", "flk"])
@pytest.mark.parametrize("name", ["lap3d8", "fem3d"])
def test_gssvx_bf16_matches_jax(kw, name):
    """``gssvx(..., executor=..., gemm_precision="bf16")`` on the CPU
    against the JAX package's ``gssvx`` with the same Options (whose CPU
    path factors at full precision), with the tolerances of clk's case
    (tests/test_torch_precision.py): the refined x agree to 1e-10
    relative and both berr ≤ 1e-12; the unrefined factor pools, slot by
    slot on the same plan, agree within 8 bf16 ulp of the pool's scale
    and differ by more than float32 rounding."""
    A = {"lap3d8": lambda: tt.laplacian_3d(8),
         "fem3d": lambda: tt.fem3d_delaunay(150, seed=1)}[name]().tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    o = dict(dtype="float32", block_size=16, gemm_precision="bf16", **kw)
    rj, jlu = J.gssvx(A, b, J.Options(**o))
    rt, lu = T.gssvx(A, b, T.Options(**o), device="cpu")
    assert rt.stat.counters["executor"] == kw["executor"]
    assert rt.stat.counters["gemm_precision"] == "default"
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    assert rt.berr.max() <= 1e-12 and rj.berr.max() <= 1e-12
    ns = lu.plan.nslots
    assert ns == jlu.plan.nslots
    jp = np.asarray(jlu._export_factors()[0])[:ns]
    tp = lu.pool[:ns].numpy()
    scale = max(1.0, float(np.abs(jp).max()))
    err = float(np.abs(tp - jp).max())
    assert 64 * EPS32 * scale < err <= 8 * EPS_BF16 * scale


def test_gssvx_ilu1_bf16_reaches_its_limits():
    """ILU(1) (flk on an ILU plan) with ``gemm_precision="bf16"`` against
    the JAX package's ILU(1) ``gssvx`` with the same Options: both held
    to berr ≤ 1e-12 and ‖Ax − b‖∞/‖b‖∞ ≤ 1e-10, the port's factor the
    low pass's."""
    A = tt.laplacian_3d(8).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    o = dict(dtype="float32", block_size=16, gemm_precision="bf16",
             ilu_level=1, max_refine_steps=60, refine_rthresh=1.0)
    rj, _ = J.gssvx(A, b, J.Options(**o))
    rt, _ = T.gssvx(A, b, T.Options(**o), device="cpu")
    assert rt.stat.counters["executor"] == "flk"
    assert rt.stat.counters["gemm_precision"] == "default"
    for r in (rt, rj):
        assert r.berr.max() <= 1e-12
        assert np.abs(A @ r.x - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("kw", [dict(executor="tck"), dict(executor="flk"),
                                dict(ilu_level=1)],
                         ids=["tck", "flk", "ilu1"])
def test_escalation_refactors_tck_flk_at_highest(armed, monkeypatch, kw):
    """A simulated stall after the bf16-first factor of tck, flk or
    ILU(1): the driver re-factors at "highest" on the same executor,
    bit-equal to a "highest" factor, recovers to berr < 1e-13, and a
    SamePattern_SameRowPerm refactor starts at "highest" (sticky)."""
    A = tt.laplacian_2d(12)
    o = T.Options(dtype="float32", block_size=8, **kw)
    lu = T.SparseLU(A, o, device="cpu")
    assert lu._gemm_prec_used == "default"
    exc = lu.executor
    real_impl = lu._refine_impl
    calls = {"n": 0}

    def stalled_once(b, x0, trans=T.Trans.NOTRANS):
        calls["n"] += 1
        x, berr = real_impl(b, x0, trans)
        if calls["n"] == 1:
            return x, np.full_like(np.atleast_1d(berr), 1e-8)
        return x, berr

    monkeypatch.setattr(lu, "_refine_impl", stalled_once)
    b = np.asarray(A @ np.ones(A.shape[0]))
    _, berr = lu.refine(b, lu.solve(b))
    assert calls["n"] == 2
    assert lu.stat.counters["precision_escalated"] == 1
    assert lu.stat.counters["gemm_precision"] == "highest"
    assert lu.executor == exc
    assert float(np.max(berr)) < 1e-13
    hi = T.SparseLU(A, o.replace(gemm_precision="highest"), device="cpu")
    assert torch.equal(lu.pool, hi.pool)
    lu.refactor(A, fact=T.Fact.SAME_PATTERN_SAME_ROWPERM)
    assert lu._gemm_prec_used == "highest"
    assert torch.equal(lu.pool, hi.pool)


@pytest.mark.parametrize("executor", ["clk", "tck", "flk"])
def test_embedded_counter_matches_jax(armed, monkeypatch, executor):
    """The ring-embedded complex64 factor runs float32's executor, and so
    its precision: the counter and the executor against the JAX
    package's under ``SLU_TPU_COMPLEX=embed`` on its Pallas path
    (``SLU_TPU_FORCE_PALLAS=interpret``)."""
    monkeypatch.setenv("SLU_TPU_FORCE_PALLAS", "interpret")
    monkeypatch.setenv("SLU_TPU_COMPLEX", "embed")
    A = tt.helmholtz_3d(3).tocsc()
    o = dict(dtype="complex64", block_size=8, align_blocks="on",
             executor=executor)
    jlu = J.SparseLU(A, J.Options(**o))
    lu = T.SparseLU(A, T.Options(**o), device="cpu")
    assert lu._embed and lu.executor == executor
    assert lu._gemm_prec_used == jlu._gemm_prec_used == "default"
    assert lu.stat.counters["gemm_precision"] == \
        jlu.stat.counters["gemm_precision"]
