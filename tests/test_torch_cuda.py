"""The port's CUDA kernels against their plain versions on the card.

Run on a machine with an NVIDIA GPU (the kernels build with nvcc at first
use): ``python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_cuda.py`` (the conftest pins JAX, which that machine
need not have).
Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.kernels import (clk, diag_lu, flk, schur,
                                                solve_gemm, sweep, tck)
from superlu_dist_tpu_torch.parallel import dist2d_rdma as rdma
from superlu_dist_tpu_torch.utils import testing as tt

pytestmark = pytest.mark.cuda

#: kernel against plain version on the same input: sums in other orders;
#: 64 ulp (of the working type) of the output's magnitude
ULPS = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' products in full FP32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _factor_plain(pool, thresh, tp, nb):
    """``clk.factor`` through the plain version of each phase."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        clk.clk_update_plain(pool, linv, tp, level)
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[lo:hi].long(),
                              tp.dstep[lo:hi].long(), thresh, tiny)
        clk.clk_trsm_plain(pool, uinv, tp, level)
    return pool, linv, uinv, tiny


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_factor_and_sweeps_match_plain(cuda, bs):
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs),
                      device=cuda)
    assert res.berr.max() < 1e-15
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
    kern = clk.factor(pool.clone(), lu._thresh(), tp, plan.nb)
    plain = _factor_plain(pool.clone(), lu._thresh(), tp, plan.nb)
    eps = np.finfo(np.float32).eps
    for k, p in zip(kern[:3], plain[:3]):
        scale = max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= ULPS * eps * scale
    X = torch.randn(plan.nb, plan.bs, 2, device=cuda)
    Xk = sweep.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape,
                     X.clone())
    Xp = X.clone()
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for level in range(tape.nlvl):
            sweep.sweep_level_plain(lu.pool, dinv, Xp, tape, level)
    scale = max(1.0, float(Xp.abs().max()))
    assert float((Xk - Xp).abs().max()) <= ULPS * eps * scale


def _flk_plain(pool, thresh, tp, nb):
    """``flk.factor`` through the plain version of each phase."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        flk.flk_update_plain(pool, linv, uinv, tp, 2 * level)
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[lo:hi].long(),
                              tp.dstep[lo:hi].long(), thresh, tiny)
        flk.flk_update_plain(pool, linv, uinv, tp, 2 * level + 1)
    return pool, linv, uinv, tiny


def _level_plain(pool, thresh, tp, nb):
    """``schur.factor`` through the plain version of each phase."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        d = slice(int(tp.dptr[level]), int(tp.dptr[level + 1]))
        lp = slice(int(tp.lptr[level]), int(tp.lptr[level + 1]))
        up = slice(int(tp.uptr[level]), int(tp.uptr[level + 1]))
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[d].long(),
                              tp.dstep[d].long(), thresh, tiny)
        schur.trsm_plain(pool, uinv, tp.lslot[lp], tp.lstep[lp], False)
        schur.trsm_plain(pool, linv, tp.uslot[up], tp.ustep[up], True)
        schur.schur_plain(pool, tp, level)
    return pool, linv, uinv, tiny


@pytest.mark.parametrize("ilu", [None, 1], ids=["exact", "ilu1"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_flk_and_level_factors_match_plain(cuda, bs, ilu):
    """The flk and level-executor factors of an exact and an ILU(1) plan
    of lap3d12 against the same factors through the plain phases."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    eps = np.finfo(np.float32).eps
    for executor, mod, plain in (("flk", flk, _flk_plain),
                                 ("pallas", schur, _level_plain)):
        res, lu = T.gssvx(A, b, T.Options(
            dtype="float32", block_size=bs, executor=executor,
            ilu_level=ilu, max_refine_steps=60, refine_rthresh=1.0),
            device=cuda)
        assert res.berr.max() < 1e-12
        plan, tp = lu.plan, lu._ftapes
        pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
        kern = mod.factor(pool.clone(), lu._thresh(), tp, plan.nb)
        ref = plain(pool.clone(), lu._thresh(), tp, plan.nb)
        for k, p in zip(kern[:3], ref[:3]):
            scale = max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= ULPS * eps * scale
        assert int(kern[3].item()) == int(ref[3].item())


@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_trsm_matches_plain(cuda, bs, left):
    g = torch.Generator(device="cpu").manual_seed(bs + left)
    pool = torch.randn(40, bs, bs, generator=g).to(cuda)
    dinv = torch.randn(9, bs, bs, generator=g).to(cuda)
    slots = torch.tensor([3, 17, 0, 39, 22], dtype=torch.int32, device=cuda)
    steps = torch.tensor([8, 0, 8, 4, 1], dtype=torch.int32, device=cuda)
    want = pool.clone()
    schur.trsm_plain(want, dinv, slots, steps, left)
    schur.trsm(pool, dinv, slots, steps, left)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((pool - want).abs().max()) \
        <= ULPS * np.finfo(np.float32).eps * scale


def test_level_executor_arrowhead_matches_plain(cuda):
    """Many steps per level feeding shared ancestor targets, at block size
    128: each target's strip sums its products in one CTA, so none is
    lost."""
    A = tt.laplacian_arrowhead()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=128,
                                      executor="pallas"), device=cuda)
    assert res.berr.max() < 1e-12
    plan, tp = lu.plan, lu._ftapes
    assert plan.n_flevels < plan.nb
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
    kern = schur.factor(pool.clone(), lu._thresh(), tp, plan.nb)
    ref = _level_plain(pool.clone(), lu._thresh(), tp, plan.nb)
    eps = np.finfo(np.float32).eps
    for k, p in zip(kern[:3], ref[:3]):
        scale = max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= ULPS * eps * scale


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_solve_gemm_and_diag_apply_match_plain(cuda, bs, transpose):
    """Level by level on lap3d12u's transposed tapes (``transpose=True``)
    or its L and U tapes (``False``), from the same X each time, with one
    and nine right-hand sides (a tile of eight and a ragged one)."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
        dtype="float32", block_size=bs), device=cuda)
    plan = lu.plan
    if transpose:
        tapes = ((solve_gemm.build_trans_tape(plan, "U", cuda), lu.uinv),
                 (solve_gemm.build_trans_tape(plan, "L", cuda), lu.linv))
    else:
        tapes = ((lu._ltape, lu.linv), (lu._utape, lu.uinv))
    eps = np.finfo(np.float32).eps
    for nrhs in (1, 9):
        X = torch.randn(plan.nb, plan.bs, nrhs, device=cuda)
        for tape, dinv in tapes:
            for level in range(tape.nlvl):
                for kern, plain, M in (
                        (solve_gemm.solve_gemm, solve_gemm.solve_gemm_plain,
                         lu.pool),
                        (solve_gemm.diag_apply, solve_gemm.diag_apply_plain,
                         dinv)):
                    Xp = X.clone()
                    kern(M, X, tape, level, transpose)
                    plain(M, Xp, tape, level, transpose)
                    torch.cuda.synchronize()
                    scale = max(1.0, float(Xp.abs().max()))
                    assert float((X - Xp).abs().max()) <= ULPS * eps * scale


def test_trans_gssvx_with_rcond_matches_cpu(cuda):
    """The TRANS + condition_number path on the card against the same
    call on the CPU (plain versions): x to 1e-10 relative, berr, the
    refinement steps, and rcond to 1e-4 relative (f32 solves in other
    summation orders)."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    opts = T.Options(dtype="float32", block_size=64, trans=T.Trans.TRANS,
                     condition_number=True)
    solve_gemm.SOLVE_GEMM.launches = solve_gemm.DIAG_APPLY.launches = 0
    rg, lu = T.gssvx(A, b, opts, device=cuda)
    assert solve_gemm.SOLVE_GEMM.launches > 0
    assert solve_gemm.DIAG_APPLY.launches > 0
    rc, _ = T.gssvx(A, b, opts, device="cpu")
    assert rg.berr.max() < 1e-15 and rc.berr.max() < 1e-15
    assert np.abs(rg.x - rc.x).max() <= 1e-10 * np.abs(rc.x).max()
    assert np.abs(A.T @ rg.x - b).max() / np.abs(b).max() < 1e-12
    assert abs(rg.rcond - rc.rcond) <= 1e-4 * rc.rcond
    assert 0 < rg.rcond <= 1


def _tck_plain(pool, thresh, tp, nb):
    """``tck.factor`` through the plain version of each phase."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        tck.tck_update_plain(pool, linv, tp, level)
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[lo:hi].long(),
                              tp.dstep[lo:hi].long(), thresh, tiny)
        clk.clk_trsm_plain(pool, uinv, tp, level)
    return pool, linv, uinv, tiny


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_tck_matches_plain(cuda, bs):
    """``executor="tck"`` on the card, then the tck factor against the
    same factor through the plain phases, on tapes of 3-row tiles (every
    column of more than 3 blocks spans several tiles) and on the kernel's
    own tile height."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    tck.UPDATE.launches = 0
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                      executor="tck"), device=cuda)
    assert res.berr.max() < 1e-15 and tck.UPDATE.launches > 0
    assert res.stat.counters["executor"] == "tck"
    plan = lu.plan
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
    eps = np.finfo(np.float32).eps
    for w in (3, None):
        tp = tck.build_tck_tapes(plan, cuda, w=w)
        if w == 3:
            assert tp.host["counts"]["tiles"] > plan.nb
        kern = tck.factor(pool.clone(), lu._thresh(), tp, plan.nb)
        ref = _tck_plain(pool.clone(), lu._thresh(), tp, plan.nb)
        for k, p in zip(kern[:3], ref[:3]):
            scale = max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= ULPS * eps * scale
        assert int(kern[3].item()) == int(ref[3].item())


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_float64_kernels_match_plain(cuda, bs):
    """Every float64 instantiation against its plain version: the level
    executor's factor (diag_lu, trsm with both flags, schur) through the
    plain phases, the L+U sweep, and solve_gemm / diag_apply with both
    flags level by level, at 64 float64 ulp."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for k in (diag_lu.KERNEL, schur.SCHUR, schur.TRSM, sweep.KERNEL):
        k.launches = 0
    res, lu = T.gssvx(A, b, T.Options(dtype="float64", block_size=bs),
                      device=cuda)
    assert res.stat.counters["executor"] == "pallas"
    assert res.berr.max() < 1e-15
    for k in (diag_lu.KERNEL, schur.SCHUR, schur.TRSM, sweep.KERNEL):
        assert k.launches > 0, k.name
    assert lu.pool.dtype == torch.float64
    eps = np.finfo(np.float64).eps
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float64, cuda)
    kern = schur.factor(pool.clone(), lu._thresh(), tp, plan.nb)
    ref = _level_plain(pool.clone(), lu._thresh(), tp, plan.nb)
    for k, p in zip(kern[:3], ref[:3]):
        scale = max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= ULPS * eps * scale
    X = torch.randn(plan.nb, plan.bs, 3, device=cuda, dtype=torch.float64)
    Xk = sweep.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape,
                     X.clone())
    Xp = X.clone()
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for level in range(tape.nlvl):
            sweep.sweep_level_plain(lu.pool, dinv, Xp, tape, level)
    assert float((Xk - Xp).abs().max()) \
        <= ULPS * eps * max(1.0, float(Xp.abs().max()))
    for transpose in (False, True):
        tapes = (((solve_gemm.build_trans_tape(plan, "U", cuda), lu.uinv),
                  (solve_gemm.build_trans_tape(plan, "L", cuda), lu.linv))
                 if transpose else ((lu._ltape, lu.linv),
                                    (lu._utape, lu.uinv)))
        X = torch.randn(plan.nb, plan.bs, 9, device=cuda,
                        dtype=torch.float64)
        for tape, dinv in tapes:
            for level in range(tape.nlvl):
                for kern, plain, M in (
                        (solve_gemm.solve_gemm, solve_gemm.solve_gemm_plain,
                         lu.pool),
                        (solve_gemm.diag_apply, solve_gemm.diag_apply_plain,
                         dinv)):
                    Xp = X.clone()
                    kern(M, X, tape, level, transpose)
                    plain(M, Xp, tape, level, transpose)
                    torch.cuda.synchronize()
                    scale = max(1.0, float(Xp.abs().max()))
                    assert float((X - Xp).abs().max()) <= ULPS * eps * scale


def test_float64_gssvx_matches_cpu(cuda):
    """float64 ``gssvx`` on the card (NOTRANS, and TRANS with the
    condition estimate) against the same calls on the CPU: x to 1e-12
    relative, berr below 1e-15, rcond to 1e-8 relative."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for trans, op in ((T.Trans.NOTRANS, A), (T.Trans.TRANS, A.T)):
        opts = T.Options(dtype="float64", block_size=64, trans=trans,
                         condition_number=trans == T.Trans.TRANS)
        rg, _ = T.gssvx(A, b, opts, device=cuda)
        rc, _ = T.gssvx(A, b, opts, device="cpu")
        assert rg.berr.max() < 1e-15 and rc.berr.max() < 1e-15
        assert np.abs(rg.x - rc.x).max() <= 1e-12 * np.abs(rc.x).max()
        assert np.abs(op @ rg.x - b).max() / np.abs(b).max() < 1e-12
        if trans == T.Trans.TRANS:
            assert abs(rg.rcond - rc.rcond) <= 1e-8 * rc.rcond


@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("pr,pc", [(2, 2), (1, 4), (4, 1), (2, 4)])
def test_rdma_kernels_match_plain(cuda, bs, pr, pc):
    """The 2D driver on the card: every entry of the RDMA factor and
    solve (rdma_diag, rdma_panel, rdma_schur, rdma_solve_gemm,
    rdma_solve_diag) launched, each phase against its plain version level
    by level on the same state, the receive counters equal to the tapes,
    and the solution against the CPU run of the same call (1e-10
    relative)."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    opts = T.Options(dtype="float32", block_size=bs, dist_executor="rdma")
    for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
        k.reset_counts()
    rg, lu = T.gssvx_dist(A, b, T.Grid2D(pr, pc), opts, device=cuda)
    for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
        assert all(v > 0 for v in k.entry_launches.values()), \
            k.entry_launches
    rc, _ = T.gssvx_dist(A, b, T.Grid2D(pr, pc), opts, device="cpu")
    assert rg.berr.max() < 1e-15
    assert np.abs(rg.x - rc.x).max() <= 1e-10 * np.abs(rc.x).max()
    for k, v in lu.factor_recv().items():
        assert np.array_equal(v, lu._ft.recv[k]), k
    for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
        for k, v in got.items():
            assert np.array_equal(v, tp.recv[k]), (tp.which, k)

    eps = np.finfo(np.float32).eps
    ft, plan = lu._ft, lu.plan

    def close(a, p):
        torch.cuda.synchronize()
        for x, y in zip(a, p):
            scale = max(1.0, float(y.float().abs().max()))
            assert float((x.float() - y.float()).abs().max()) \
                <= ULPS * eps * scale

    from superlu_dist_tpu_torch.parallel import dist2d
    st = rdma.new_factor_state(dist2d.init_local_pools(
        plan, lu.dplan, lu._a3_data, np.float32, cuda), ft)
    th = lu._thresh()
    for level in range(ft.nlvl):
        for kern, plain in (
                (lambda s: rdma.rdma_diag(s, th, ft, level),
                 lambda s: rdma.rdma_diag_plain(s, th, ft, level)),
                (lambda s: rdma.rdma_panel(s, ft, level),
                 lambda s: rdma.rdma_panel_plain(s, ft, level)),
                (lambda s: rdma.rdma_schur(s, ft, level),
                 lambda s: rdma.rdma_schur_plain(s, ft, level))):
            ref = rdma.FactorState.of([t.clone() for t in st.tensors()],
                                      ft.ndev)
            kern(st)
            plain(ref)
            close(st.tensors(), ref.tensors())
    for nrhs in (1, 3, 9):
        B = torch.randn(plan.nb, plan.bs, nrhs, device=cuda)
        for tp, dinv in ((lu._lt, lu.linv), (lu._ut, lu.uinv)):
            ss = rdma.new_sweep_state([B.clone() for _ in lu.pool], tp)
            for level in range(tp.nlvl):
                for kern, plain, M in (
                        (rdma.rdma_solve_gemm, rdma.rdma_solve_gemm_plain,
                         lu.pool),
                        (rdma.rdma_solve_diag, rdma.rdma_solve_diag_plain,
                         dinv)):
                    ref = rdma.SweepState(*([t.clone() for t in ts] for ts in
                                            (ss.X, ss.P, ss.slots, ss.recv)))
                    kern(M, ss, tp, level)
                    plain(M, ref, tp, level)
                    close(ss.X + ss.P + ss.slots + ss.recv,
                          ref.X + ref.P + ref.slots + ref.recv)



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_solve_level_matches_plain(cuda, bs, dtype):
    """The two-pass solve_level (pass 1 over chunks, fused pass 2) against
    solve_level_plain level by level, from the same X, with one and nine
    right-hand sides, on lap3d12u's transposed tapes (``transpose=True``)
    and its L and U tapes (``False``), chunked by the level rule and by
    c = 1 and 2 (rows of several chunks)."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
        dtype="float32" if dtype == torch.float32 else "float64",
        block_size=bs), device=cuda)
    plan = lu.plan
    eps = np.finfo(np.float32 if dtype == torch.float32 else np.float64).eps

    def make_tape(which, transpose, chunk):
        if transpose:
            sched = blocklu.trans_schedule(plan, which)[1:]
        else:
            p = "lsol" if which == "L" else "usol"
            sched = [getattr(plan, f"{p}_{f}") for f in
                     ("gslot", "gsrc", "gdst", "dptr", "diag", "nlvl")]
        return sweep.csr_tape(plan.nb, *sched, cuda, chunk)

    for chunk in (None, 1, 2):
        for transpose in (False, True):
            tapes = ((make_tape("U", True, chunk), lu.uinv),
                     (make_tape("L", True, chunk), lu.linv)) if transpose \
                else ((make_tape("L", False, chunk), lu.linv),
                      (make_tape("U", False, chunk), lu.uinv))
            for nrhs in (1, 9):
                X = torch.randn(plan.nb, plan.bs, nrhs, device=cuda,
                                dtype=dtype)
                for tape, dinv in tapes:
                    for level in range(tape.nlvl):
                        Xp = X.clone()
                        solve_gemm.solve_level(lu.pool, dinv, X, tape, level,
                                               transpose)
                        solve_gemm.solve_level_plain(lu.pool, dinv, Xp, tape,
                                                     level, transpose)
                        torch.cuda.synchronize()
                        scale = max(1.0, float(Xp.abs().max()))
                        assert float((X - Xp).abs().max()) \
                            <= ULPS * eps * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_transposed_solves_are_bit_equal(cuda, dtype):
    """Two transposed solves of the same b (one and nine right-hand sides)
    give bit-equal results, and the kernels launched."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
        dtype="float32" if dtype == torch.float32 else "float64",
        block_size=128), device=cuda)
    plan = lu.plan
    tu, tl = (solve_gemm.build_trans_tape(plan, w, cuda) for w in "UL")
    for nrhs in (1, 9):
        B = torch.randn(plan.nb, plan.bs, nrhs, device=cuda, dtype=dtype)
        solve_gemm.SOLVE_GEMM.reset_counts()
        solve_gemm.DIAG_APPLY.reset_counts()
        X1 = solve_gemm.solve_transposed(lu.pool, lu.uinv, lu.linv, tu, tl,
                                         B.clone())
        X2 = solve_gemm.solve_transposed(lu.pool, lu.uinv, lu.linv, tu, tl,
                                         B.clone())
        torch.cuda.synchronize()
        assert solve_gemm.SOLVE_GEMM.launches > 0
        assert solve_gemm.DIAG_APPLY.launches == 2 * (tu.nlvl + tl.nlvl)
        assert torch.equal(X1, X2)


def test_spmv_calls_are_bit_equal(cuda):
    """The refinement SpMVs and the grid's dist_spmv give bit-equal
    results on two calls (float64, three right-hand sides, a matrix with
    hub rows), and agree with scipy."""
    from superlu_dist_tpu_torch.ops import spmv
    from superlu_dist_tpu_torch.parallel import dist2d
    A = tt.circuit_graph(20000, seed=3).tocsc()
    x = np.random.default_rng(0).standard_normal((A.shape[0], 3))
    xt = torch.as_tensor(x, device=cuda)
    coo = spmv.coo_arrays(A, np.float64, cuda)
    for fn, ref in ((spmv.spmv, A @ x), (spmv.abs_spmv, abs(A) @ x),
                    (spmv.spmv_t, A.T @ x), (spmv.abs_spmv_t, abs(A).T @ x)):
        y1, y2 = fn(coo, xt), fn(coo, xt)
        assert torch.equal(y1, y2)
        assert np.abs(y1.cpu().numpy() - ref).max() \
            <= 1e-13 * np.abs(ref).max()
    shards = dist2d.coo_shards(A, 4, np.float64, cuda)
    y1 = dist2d.dist_spmv(shards, xt, A.shape[0])
    assert torch.equal(y1, dist2d.dist_spmv(shards, xt, A.shape[0]))


def test_ilu_refinement_repeats(cuda):
    """Two ILU(1) gssvx calls give bit-equal x and the same refinement
    steps (the residual's sums have a fixed order)."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    opts = T.Options(dtype="float32", block_size=64, ilu_level=1,
                     max_refine_steps=60, refine_rthresh=1.0)
    r1, _ = T.gssvx(A, b, opts, device=cuda)
    r2, _ = T.gssvx(A, b, opts, device=cuda)
    assert r1.stat.refine_steps == r2.stat.refine_steps
    assert np.array_equal(r1.x, r2.x)
