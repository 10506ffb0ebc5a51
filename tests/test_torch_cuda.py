"""The port's CUDA kernels against their plain versions on the card.

Run on a machine with an NVIDIA GPU (the kernels build with nvcc at first
use): ``python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_cuda.py`` (the conftest pins JAX, which that machine
need not have).
Without a CUDA device every test here skips."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
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
    # the FP32 pass (the card's "auto" is bf16-first)
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                      gemm_precision="highest"),
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
    Xk = solve_gemm.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape,
                          X.clone())
    Xp = X.clone()
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for level in range(tape.nlvl):
            sweep.sweep_level_plain(lu.pool, dinv, Xp, tape, level)
    scale = max(1.0, float(Xp.abs().max()))
    assert float((Xk - Xp).abs().max()) <= ULPS * eps * scale


def _sym_random(n, density, seed):
    """A random symmetric pattern with a dominant diagonal."""
    import scipy.sparse as sp
    M = sp.random(n, n, density=density, random_state=seed, format="csc")
    return (M + M.T + sp.eye(n) * (n * 0.5)).tocsc().astype(np.float32)


@pytest.mark.parametrize("mat", ["lap3d12", "random1", "random2"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_clk_update_matches_plain(cuda, bs, mat):
    """The wave kernel of clk_update against clk_update_plain (the
    reference order) level by level from the same pool, on lap3d12 in the
    driver's order and on random patterns in their natural order; the
    factor goes on with the kernel's output. Launches: one per wave."""
    if mat == "lap3d12":
        A = tt.laplacian_3d(12).tocsc()
        _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
            dtype="float32", block_size=bs), device=cuda)
        plan, data = lu.plan, lu._a3_data
    else:
        A = _sym_random(6 * bs, 0.004 * int(mat[-1]), int(mat[-1]))
        plan, data = block_symbolic(A, bs), A.data
    tp = clk.build_clk_tapes(plan, cuda)
    pool = blocklu.init_pool(plan, data, np.float32, cuda)
    linv = torch.zeros((plan.nb, bs, bs), device=cuda)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
    eps = np.finfo(np.float32).eps
    clk.UPDATE.reset_counts()
    for level in range(tp.nlvl):
        ref = pool.clone()
        clk.clk_update(pool, linv, tp, level)
        clk.clk_update_plain(ref, linv, tp, level)
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.abs().max()))
        assert float((pool - ref).abs().max()) <= ULPS * eps * scale
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        0.0, tiny)
        clk.clk_trsm(pool, uinv, tp, level)
    assert clk.UPDATE.launches == int(tp.lwave[-1]) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_notrans_solve_matches_plain(cuda, bs, dtype):
    """The NOTRANS solve through the two passes (solve_gemm.solve, counted
    on SWEEP alone) against the plain levels, with one and three
    right-hand sides, and two solves of one X bit-equal."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
        dtype="float32" if dtype == torch.float32 else "float64",
        block_size=bs), device=cuda)
    plan = lu.plan
    eps = np.finfo(np.float32 if dtype == torch.float32 else np.float64).eps
    tapes = ((lu._ltape, lu.linv), (lu._utape, lu.uinv))
    for nrhs in (1, 3):
        X = torch.randn(plan.nb, plan.bs, nrhs, device=cuda, dtype=dtype)
        for k in (solve_gemm.SWEEP, solve_gemm.SOLVE_GEMM,
                  solve_gemm.DIAG_APPLY):
            k.reset_counts()
        Xk = solve_gemm.solve(lu.pool, lu.linv, lu.uinv, *(t for t, _ in
                                                         tapes), X.clone())
        X2 = solve_gemm.solve(lu.pool, lu.linv, lu.uinv, *(t for t, _ in
                                                         tapes), X.clone())
        torch.cuda.synchronize()
        assert torch.equal(Xk, X2)
        assert solve_gemm.SWEEP.launches >= 2 * sum(t.nlvl for t, _ in
                                                   tapes)
        assert solve_gemm.SOLVE_GEMM.launches == 0
        assert solve_gemm.DIAG_APPLY.launches == 0
        Xp = X.clone()
        for tape, dinv in tapes:
            for level in range(tape.nlvl):
                solve_gemm.solve_level_plain(lu.pool, dinv, Xp, tape, level,
                                             False)
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


def _level_kernel(pool, thresh, tp, nb, wide):
    """``schur.factor`` with schur's band geometry forced by ``wide``."""
    linv, uinv, tiny = _zero_inverses(pool, nb)
    for level in range(tp.nlvl):
        d = slice(int(tp.dptr[level]), int(tp.dptr[level + 1]))
        lp = slice(int(tp.lptr[level]), int(tp.lptr[level + 1]))
        up = slice(int(tp.uptr[level]), int(tp.uptr[level + 1]))
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[d], tp.dstep[d], thresh,
                        tiny)
        schur.trsm(pool, uinv, tp.lslot[lp], tp.lstep[lp], left=False)
        schur.trsm(pool, linv, tp.uslot[up], tp.ustep[up], left=True)
        schur.schur(pool, tp, level, wide)
    return pool, linv, uinv, tiny


def _flk_kernel(pool, thresh, tp, nb, wide):
    """``flk.factor`` with the band geometry forced by ``wide``."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        flk.flk_update(pool, linv, uinv, tp, 2 * level, wide)
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        thresh, tiny)
        flk.flk_update(pool, linv, uinv, tp, 2 * level + 1, wide)
    return pool, linv, uinv, tiny


@pytest.mark.parametrize("ilu", [None, 1], ids=["exact", "ilu1"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_flk_and_level_factors_match_plain(cuda, bs, ilu):
    """The flk and level-executor factors of an exact and an ILU(1) plan
    of lap3d12 against the same factors through the plain phases; flk
    also on the automatic chunks and on chunks of one and of three
    products (so that pass 2 runs for diagonal, L and U targets), each
    with the bands the kernel chooses, bands of 16 and bands of 64. 64
    float32 ulp of the output's magnitude (ULPS): the plain version sums
    each product in another order."""
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
        ref = plain(pool.clone(), lu._thresh(), tp, plan.nb)
        runs = [mod.factor(pool.clone(), lu._thresh(), tp, plan.nb)]
        if executor == "flk":
            for chunk in (None, 1, 3):
                tc = flk.build_flk_tapes(plan, cuda, chunk=chunk)
                if chunk == 1:   # pass 2 on every kind of target
                    fins = set(tc.host["tfin"][tc.host["mtgt"]].tolist())
                    assert fins == {flk.FIN_NONE, flk.FIN_L, flk.FIN_U}
                runs += [_flk_kernel(pool.clone(), lu._thresh(), tc,
                                     plan.nb, wide) for wide in (-1, 0, 1)]
        for kern in runs:
            for k, p in zip(kern[:3], ref[:3]):
                scale = max(1.0, float(p.abs().max()))
                assert float((k - p).abs().max()) <= ULPS * eps * scale
            assert int(kern[3].item()) == int(ref[3].item())


def test_flk_factors_are_bit_equal(cuda):
    """Two flk factors of one matrix, and two ILU(1) gssvx calls, are bit
    for bit equal: every sum runs in the tapes' fixed order (chunks in
    plan order, then the chunks in chunk order), with no atomics."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for bs in (32, 64, 128):
        _, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                        executor="flk"), device=cuda)
        plan, tp = lu.plan, lu._ftapes
        pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
        f1 = flk.factor(pool.clone(), lu._thresh(), tp, plan.nb)
        f2 = flk.factor(pool.clone(), lu._thresh(), tp, plan.nb)
        for x, y in zip(f1, f2):
            assert torch.equal(x, y)
    opts = T.Options(dtype="float32", block_size=128, ilu_level=1,
                     max_refine_steps=60, refine_rthresh=1.0)
    r1, _ = T.gssvx(A, b, opts, device=cuda)
    r2, _ = T.gssvx(A, b, opts, device=cuda)
    assert r1.stat.refine_steps == r2.stat.refine_steps
    assert np.array_equal(r1.x, r2.x)


#: the element types of the level executor's trsm
TRSM_DTYPES = [torch.float32, torch.float64, torch.complex64,
               torch.complex128]


def _eps(dtype) -> float:
    """The unit roundoff of ``dtype``'s real parts."""
    return float(np.finfo(np.float32 if dtype in (torch.float32,
                                                  torch.complex64)
                          else np.float64).eps)


@pytest.mark.parametrize("dtype", TRSM_DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_trsm_matches_plain(cuda, bs, left, dtype):
    """A few panels (bands of 16 in complex128's FP64 tensor-core kernel,
    and in the others' at bs 128 and 64)."""
    g = torch.Generator(device="cpu").manual_seed(bs + left)
    pool = torch.randn(40, bs, bs, generator=g, dtype=dtype).to(cuda)
    dinv = torch.randn(9, bs, bs, generator=g, dtype=dtype).to(cuda)
    slots = torch.tensor([3, 17, 0, 39, 22], dtype=torch.int32, device=cuda)
    steps = torch.tensor([8, 0, 8, 4, 1], dtype=torch.int32, device=cuda)
    want = pool.clone()
    schur.trsm_plain(want, dinv, slots, steps, left)
    schur.trsm(pool, dinv, slots, steps, left)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((pool - want).abs().max()) <= ULPS * _eps(dtype) * scale


@pytest.mark.parametrize("dtype", TRSM_DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_trsm_many_panels_matches_plain(cuda, bs, dtype):
    """300 panels of a 320-slot pool in one launch per flag, over 12
    steps that repeat (as a level lists several panels of one column),
    with the triangular inverses that diag_lu leaves: L panels by uinv,
    U panels by linv."""
    g = torch.Generator(device="cpu").manual_seed(bs)
    nb = 12
    diag = torch.randn(nb, bs, bs, generator=g, dtype=dtype)
    diag += bs * torch.eye(bs, dtype=dtype)
    diag = diag.to(cuda)
    linv = torch.zeros_like(diag)
    uinv = torch.zeros_like(diag)
    tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
    idx = torch.arange(nb, dtype=torch.int32, device=cuda)
    diag_lu.diag_lu(diag, linv, uinv, idx, idx, 0.0, tiny)
    assert torch.equal(linv, torch.tril(linv))
    assert torch.equal(uinv, torch.triu(uinv))
    pool = torch.randn(320, bs, bs, generator=g, dtype=dtype).to(cuda)
    slots = torch.randperm(320, generator=g)[:300].to(torch.int32).to(cuda)
    steps = torch.randint(0, nb, (300,), generator=g,
                          dtype=torch.int32).to(cuda)
    eps = _eps(dtype)
    for left, dinv in ((False, uinv), (True, linv)):
        want = pool.clone()
        schur.trsm_plain(want, dinv, slots, steps, left)
        n0 = schur.TRSM.launches
        schur.trsm(pool, dinv, slots, steps, left)
        torch.cuda.synchronize()
        assert schur.TRSM.launches == n0 + 1
        scale = max(1.0, float(want.abs().max()))
        assert float((pool - want).abs().max()) <= ULPS * eps * scale


@pytest.mark.parametrize("count", [5, 300])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_complex128_trsm_repeats_and_batch_bit_equal(cuda, bs, count):
    """complex128's trsm (the FP64 tensor cores' kernel) in a launch of 5
    panels (bands of 16) and of 300 (the wide bands), both flags: two
    launches on the same input give the same bits, and trsm_batch on
    three stacked members gives each member the bits of trsm on it alone
    (the geometry is chosen from one member's count)."""
    g = torch.Generator(device="cpu").manual_seed(7 * bs + count)
    dt = torch.complex128
    P = torch.randn(3, 320, bs, bs, generator=g, dtype=dt).to(cuda)
    D = torch.randn(3, 12, bs, bs, generator=g, dtype=dt).to(cuda)
    slots = torch.randperm(320, generator=g)[:count].to(torch.int32)
    steps = torch.randint(0, 12, (count,), generator=g, dtype=torch.int32)
    slots, steps = slots.to(cuda), steps.to(cuda)
    for left in (False, True):
        a, b = P[0].clone(), P[0].clone()
        schur.trsm(a, D[0], slots, steps, left)
        schur.trsm(b, D[0], slots, steps, left)
        Pb = P.clone()
        n0 = schur.TRSM_BATCH.launches
        schur.trsm_batch(Pb, D, slots, steps, left)
        torch.cuda.synchronize()
        assert schur.TRSM_BATCH.launches == n0 + 1
        assert torch.equal(a, b)
        for m in range(3):
            one = P[m].clone()
            schur.trsm(one, D[m], slots, steps, left)
            assert torch.equal(Pb[m], one), (left, m)
        want = P[0].clone()
        schur.trsm_plain(want, D[0], slots, steps, left)
        scale = max(1.0, float(want.abs().max()))
        assert float((a - want).abs().max()) <= ULPS * _eps(dt) * scale


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_clk_trsm_matches_plain(cuda, bs):
    """clk_trsm alone on the level of lap3d12's clk plan with the most L
    blocks, its input made by the kernels of the levels below and that
    level's update and diag_lu."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    _, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs),
                    device=cuda)
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
    linv = torch.zeros((plan.nb, bs, bs), dtype=pool.dtype, device=cuda)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
    level = int(np.argmax(np.diff(tp.lptr)))
    assert tp.lptr[level + 1] - tp.lptr[level] > 1
    for lvl in range(level):
        clk.factor_level(pool, linv, uinv, tiny, th, tp, lvl)
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    clk.clk_update(pool, linv, tp, level)
    diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], th,
                    tiny)
    want = pool.clone()
    clk.clk_trsm_plain(want, uinv, tp, level)
    n0 = clk.TRSM.launches
    clk.clk_trsm(pool, uinv, tp, level)
    torch.cuda.synchronize()
    assert clk.TRSM.launches == n0 + 1
    scale = max(1.0, float(want.abs().max()))
    assert float((pool - want).abs().max()) \
        <= ULPS * np.finfo(np.float32).eps * scale


def _adversarial(seed, n=1280):
    """tests/test_torch_schur.py's random pattern, with many duplicate
    Schur targets per level."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=0.01, random_state=rng.integers(1 << 30),
                  format="csc")
    return sp.csc_matrix(M + M.T + sp.eye(n) * (3.0 * n))


@pytest.mark.parametrize("wide", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_schur_matches_plain(cuda, bs, dtype, wide):
    """``schur`` against ``schur_plain`` level by level, both on the same
    input (the factor goes on through the plain phases), on lap3d12's
    level plan and on a random pattern with many duplicate targets per
    level, with the bands the kernel chooses (``wide`` -1), bands of 16
    (0) and of 64 (1); 64 ulp of the working type (ULPS) of the output's
    magnitude, as the plain version sums each product in another order.
    Before that, two level factors of one pool in those bands are
    bit-equal: every target sums its products in the tapes' order, with
    no atomics."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    eps = np.finfo(npd).eps
    for A in (tt.laplacian_3d(12).tocsc(), _adversarial(11)):
        _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
            dtype=np.dtype(npd).name, block_size=bs, executor="pallas"),
            device=cuda)
        plan, tp = lu.plan, lu._ftapes
        assert np.diff(tp.host["cptr"]).max() > 1   # chains, not lone products
        pool = blocklu.init_pool(plan, lu._a3_data, npd, cuda)
        f1, f2 = (_level_kernel(pool.clone(), lu._thresh(), tp, plan.nb,
                                wide) for _ in range(2))
        for x, y in zip(f1, f2):
            assert torch.equal(x, y)
        linv, uinv, tiny = _zero_inverses(pool, plan.nb)
        for level in range(tp.nlvl):
            d = slice(int(tp.dptr[level]), int(tp.dptr[level + 1]))
            lp = slice(int(tp.lptr[level]), int(tp.lptr[level + 1]))
            up = slice(int(tp.uptr[level]), int(tp.uptr[level + 1]))
            diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[d].long(),
                                  tp.dstep[d].long(), lu._thresh(), tiny)
            schur.trsm_plain(pool, uinv, tp.lslot[lp], tp.lstep[lp], False)
            schur.trsm_plain(pool, linv, tp.uslot[up], tp.ustep[up], True)
            got = pool.clone()
            n0 = schur.SCHUR.launches
            schur.schur(got, tp, level, wide)
            schur.schur_plain(pool, tp, level)
            torch.cuda.synchronize()
            lo, hi = int(tp.sptr[level]), int(tp.sptr[level + 1])
            assert schur.SCHUR.launches == n0 + (hi > lo)
            scale = max(1.0, float(pool.abs().max()))
            assert float((got - pool).abs().max()) <= ULPS * eps * scale


def test_level_executor_arrowhead_matches_plain(cuda):
    """Many steps per level feeding shared ancestor targets, at block size
    128: each band of a target sums its products in one CTA, so none is
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
    # the FP32 pass on both devices (the card's "auto" is bf16-first)
    opts = T.Options(dtype="float32", block_size=64, trans=T.Trans.TRANS,
                     condition_number=True, gemm_precision="highest")
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
    own tile height (shortened by the level rule, and not); then level by
    level from one pool, phase A
    (``tck_waves``) and phase B (``tck_tiles``) against their plain
    versions on tapes of 3-row tiles on every level, and phase A's U
    blocks against ``clk_update``'s, bit for bit (one wave kernel, one
    order)."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    tck.UPDATE.launches = 0
    # the FP32 pass ("auto" factors bf16-first on the card)
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                      executor="tck",
                                      gemm_precision="highest"), device=cuda)
    assert res.berr.max() < 1e-15 and tck.UPDATE.launches > 0
    assert res.stat.counters["executor"] == "tck"
    plan = lu.plan
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
    eps = np.finfo(np.float32).eps
    for w in (3, None, tck.tile_rows(bs)):
        tp = tck.build_tck_tapes(plan, cuda, w=w)
        if w == 3:
            assert tp.host["counts"]["tiles"] > plan.nb
        kern = tck.factor(pool.clone(), lu._thresh(), tp, plan.nb)
        ref = _tck_plain(pool.clone(), lu._thresh(), tp, plan.nb)
        for k, p in zip(kern[:3], ref[:3]):
            scale = max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= ULPS * eps * scale
        assert int(kern[3].item()) == int(ref[3].item())

    tp = tck.build_tck_tapes(plan, cuda, w=3)
    h = tp.host
    assert h["tiles"][:, 1].max() == 3
    tcol = np.searchsorted(np.searchsorted(plan.slot_col, np.arange(
        plan.nb + 1)), h["tiles"][:, 0], side="right")
    assert np.bincount(tcol).max() > 1, "no column of several tiles"
    cp = clk.build_clk_tapes(plan, cuda)
    u = torch.as_tensor(np.asarray(plan.u_slots, dtype=np.int64),
                        device=cuda)
    tck.UPDATE.reset_counts()
    p, linv, uinv, tiny = pool.clone(), *_zero_inverses(pool, plan.nb)
    for level in range(tp.nlvl):
        for kern, plain in ((lambda q: tck.tck_waves(q, linv, tp, level),
                             lambda q: tck.tck_waves_plain(q, linv, tp,
                                                           level)),
                            (lambda q: tck.tck_tiles(q, tp, level),
                             lambda q: tck.tck_tiles_plain(q, tp, level))):
            ref = p.clone()
            kern(p)
            plain(ref)
            scale = max(1.0, float(ref.abs().max()))
            assert float((p - ref).abs().max()) <= ULPS * eps * scale
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu(p, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        clk.clk_trsm(p, uinv, tp, level)
    assert all(v > 0 for v in tck.UPDATE.entry_launches.values())
    # phase A and clk_update from one pool: equal U blocks, bit for bit
    p, linv, uinv, tiny = pool.clone(), *_zero_inverses(pool, plan.nb)
    for level in range(tp.nlvl):
        ref = p.clone()
        clk.clk_update(ref, linv, cp, level)
        tck.tck_waves(p, linv, tp, level)
        assert torch.equal(p[u], ref[u])
        tck.tck_tiles(p, tp, level)
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu(p, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        clk.clk_trsm(p, uinv, tp, level)


def _zero_inverses(pool, nb):
    """Zero linv, uinv (nb, bs, bs) and tiny-pivot count beside ``pool``."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    return linv, torch.zeros_like(linv), torch.zeros(
        1, dtype=torch.int32, device=pool.device)


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_float64_kernels_match_plain(cuda, bs):
    """Every float64 instantiation against its plain version: the level
    executor's factor (diag_lu, trsm with both flags, schur in each band
    geometry) through the plain phases, the L+U sweep, and solve_gemm /
    diag_apply with both flags level by level, at 64 float64 ulp."""
    A = tt.laplacian_3d_unsym(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for k in (diag_lu.KERNEL, schur.SCHUR, schur.TRSM, solve_gemm.SWEEP):
        k.launches = 0
    res, lu = T.gssvx(A, b, T.Options(dtype="float64", block_size=bs),
                      device=cuda)
    assert res.stat.counters["executor"] == "pallas"
    assert res.berr.max() < 1e-15
    for k in (diag_lu.KERNEL, schur.SCHUR, schur.TRSM, solve_gemm.SWEEP):
        assert k.launches > 0, k.name
    assert lu.pool.dtype == torch.float64
    eps = np.finfo(np.float64).eps
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float64, cuda)
    ref = _level_plain(pool.clone(), lu._thresh(), tp, plan.nb)
    # schur's bands as the kernel chooses them, then of 16 and of 64
    for kern in [schur.factor(pool.clone(), lu._thresh(), tp, plan.nb)] + [
            _level_kernel(pool.clone(), lu._thresh(), tp, plan.nb, wide)
            for wide in (0, 1)]:
        for k, p in zip(kern[:3], ref[:3]):
            scale = max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= ULPS * eps * scale
    X = torch.randn(plan.nb, plan.bs, 3, device=cuda, dtype=torch.float64)
    Xk = solve_gemm.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape,
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


#: tile with replaced pivots (compared in float64 only): its entries reach
#: ~1/thresh and its inverses ~1/thresh², so either elimination order's
#: roundoff grows by ~1e6; the CPU test of the plain version holds the JAX
#: tile LUs to it at the same limit
TINY_RTOL64 = 1e-9


def _tiny_tile(bs, dtype):
    """The tiny-pivot tile of ``tests/test_torch_diag_lu.py::tiles``:
    pivots 1e-9, -1e-9 and 0 at 5, 9 and 12, uncoupled from the rows and
    columns before them, so each stays tiny through the elimination."""
    T = np.random.default_rng(0).standard_normal((bs, bs)) + bs * np.eye(bs)
    for j, v in ((5, 1e-9), (9, -1e-9), (12, 0.0)):
        T[j, :j] = 0.0
        T[:j, j] = 0.0
        T[j, j] = v
    return T.astype(dtype)


@pytest.mark.parametrize("ntile", [1, 140], ids=["1tile", "140tiles"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_diag_lu_matches_plain(cuda, bs, dtype, ntile):
    """diag_lu alone against ``lu_inv_plain``, in launches of 1 tile and of
    140 (two waves of one CTA per SM on 132 SMs) scattered over a pool
    with permuted steps: diagonally dominant tiles at 64 ulp of scale,
    then the same launch with the tiny-pivot tile first, whose 3 replaced
    pivots are counted and signed +thresh, -thresh, +thresh."""
    thresh = 1e-3
    npd = np.float32 if dtype == torch.float32 else np.float64
    eps = np.finfo(npd).eps
    rng = np.random.default_rng(bs + ntile)
    base = rng.standard_normal((ntile, bs, bs)) + bs * np.eye(bs)
    slots = rng.permutation(ntile + 3)[:ntile] + 1
    steps = rng.permutation(ntile)
    for with_tiny in (False, True):
        tiles = base.astype(npd)
        if with_tiny:
            tiles[0] = _tiny_tile(bs, npd)
        pool = torch.zeros(ntile + 4, bs, bs, dtype=dtype, device=cuda)
        pool[torch.as_tensor(slots, device=cuda)] = torch.as_tensor(
            tiles, device=cuda)
        linv = torch.zeros(ntile, bs, bs, dtype=dtype, device=cuda)
        uinv = torch.zeros_like(linv)
        tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
        sl = torch.as_tensor(slots, dtype=torch.int32, device=cuda)
        st = torch.as_tensor(steps, dtype=torch.int32, device=cuda)
        diag_lu.diag_lu(pool, linv, uinv, sl, st, thresh, tiny)
        torch.cuda.synchronize()
        LU, li, ui, nt = diag_lu.lu_inv_plain(
            torch.as_tensor(tiles, device=cuda), thresh)
        assert int(tiny.item()) == int(nt) == (3 if with_tiny else 0)
        got = (pool[sl.long()], linv[st.long()], uinv[st.long()])
        if with_tiny:
            assert [float(got[0][0, j, j]) for j in (5, 9, 12)] == \
                [float(npd(v)) for v in (thresh, -thresh, thresh)]
        first = 1 if with_tiny else 0
        for g, p in zip(got, (LU, li, ui)):
            if ntile > first:
                scale = max(1.0, float(p[first:].abs().max()))
                assert float((g[first:] - p[first:]).abs().max()) \
                    <= ULPS * eps * scale
            if with_tiny and dtype == torch.float64:
                scale = max(1.0, float(p[0].abs().max()))
                assert float((g[0] - p[0]).abs().max()) \
                    <= TINY_RTOL64 * scale
        untouched = np.setdiff1d(np.arange(ntile + 4), slots)
        assert not pool[torch.as_tensor(untouched, device=cuda)].any()


#: a growth tile (diagonal shift sqrt(bs)) against the plain version run
#: in float64 or complex128, in units of the working type's roundoff at
#: the output's magnitude: the tiles' growth amplifies either algorithm's
#: roundoff. The plain version itself, run in float32 and complex64 on
#: these tiles, is off by up to 622, 307 and 14,200 such units at bs 32,
#: 64 and 128 (on the CPU); the limits leave 4 to 27 times that for the
#: kernel's other order of summation.
GROWTH_ULPS = {32: 4096, 64: 8192, 128: 65536}
DIAG_DTYPES = [torch.float32, torch.float64, torch.complex64,
               torch.complex128]


@pytest.mark.parametrize("dtype", DIAG_DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_diag_lu_repeats_batch_bit_equal_and_growth(cuda, bs, dtype):
    """diag_lu on 20 tiles in each of the four types: a second launch on
    the same tiles repeats the first bit for bit, and ``diag_lu_batch`` on
    three members gives each member diag_lu's output on it alone bit for
    bit (pool, inverses, tiny count), on diagonally dominant tiles (shift
    bs) and on tiles with growth (shift sqrt(bs)); the growth tiles' LU
    and inverses then against the plain version in the wide type, at the
    tolerance GROWTH_ULPS states."""
    rng = np.random.default_rng(bs)
    n, members, thresh = 20, 3, 1e-6
    wide = torch.complex128 if dtype.is_complex else torch.float64
    eps = _eps(dtype)
    sl = torch.as_tensor(rng.permutation(n + 2)[:n] + 1, dtype=torch.int32,
                         device=cuda)
    st = torch.as_tensor(rng.permutation(n), dtype=torch.int32,
                         device=cuda)

    def make(shift):
        shape = (members, n, bs, bs)
        t = rng.standard_normal(shape) + shift * np.eye(bs)
        if dtype.is_complex:
            t = t + 1j * rng.standard_normal(shape)
        return torch.as_tensor(t).to(cuda).to(dtype)

    def run(tiles):
        pool = torch.zeros(n + 3, bs, bs, dtype=dtype, device=cuda)
        pool[sl.long()] = tiles
        linv = torch.zeros(n, bs, bs, dtype=dtype, device=cuda)
        uinv = torch.zeros_like(linv)
        tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
        diag_lu.diag_lu(pool, linv, uinv, sl, st, thresh, tiny)
        torch.cuda.synchronize()
        return pool, linv, uinv, tiny

    for shift in (float(bs), float(np.sqrt(bs))):
        tiles = make(shift)
        outs = [run(tiles[m]) for m in range(members)]
        assert all(torch.equal(a, b) for a, b in zip(outs[0], run(tiles[0])))
        P = torch.zeros(members, n + 3, bs, bs, dtype=dtype, device=cuda)
        P[:, sl.long()] = tiles
        L = torch.zeros(members, n, bs, bs, dtype=dtype, device=cuda)
        U = torch.zeros_like(L)
        th = torch.full((members,), thresh, dtype=P.real.dtype, device=cuda)
        tb = torch.zeros(members, dtype=torch.int32, device=cuda)
        diag_lu.diag_lu_batch(P, L, U, sl, st, th, tb)
        torch.cuda.synchronize()
        for m, (p1, l1, u1, t1) in enumerate(outs):
            assert torch.equal(P[m], p1) and torch.equal(L[m], l1)
            assert torch.equal(U[m], u1) and int(tb[m]) == int(t1.item())
    pool, linv, uinv, tiny = outs[0]
    got = (pool[sl.long()], linv[st.long()], uinv[st.long()])
    ref = diag_lu.lu_inv_plain(tiles[0].to(wide), thresh)
    assert int(tiny.item()) == int(ref[3]) == 0
    for g, r in zip(got, ref):
        scale = max(1.0, float(r.abs().max()))
        err = float((g.to(wide) - r).abs().max())
        assert err <= GROWTH_ULPS[bs] * eps * scale


@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("pr,pc", [(2, 2), (1, 4), (4, 1), (2, 4)])
def test_rdma_kernels_match_plain(cuda, bs, pr, pc):
    """The 2D driver on the card: every entry of the RDMA factor and
    solve (rdma_diag, rdma_panel, rdma_schur, rdma_solve_chunks,
    rdma_solve_sum, rdma_solve_diag) launched, each phase against its
    plain version level by level on the same state (the factor's panels
    and Schur products in the bands the kernels choose, in bands of 16
    and in bands of 64; the solve on the automatic chunks and on chunks of
    at most two products, so that chains are cut, and the transposed Uᵀ
    and Lᵀ sweeps), within 64 float32 ulp of the output's magnitude
    (ULPS), the receive counters (which the kernels' puts tally, and the
    plain versions too) equal to each other and to the receive tapes, and
    the solution against the CPU run of the same call (1e-10 relative).
    A float32 call launches the ``_f32`` entries only."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    opts = T.Options(dtype="float32", block_size=bs, dist_executor="rdma")
    for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
        k.reset_counts()
    rg, lu = T.gssvx_dist(A, b, T.Grid2D(pr, pc), opts, device=cuda)
    for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
        assert all((v > 0) == e.endswith("_f32")
                   for e, v in k.entry_launches.items()), k.entry_launches
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
    th = lu._thresh()
    for wide in (-1, 0, 1):   # the bands the kernels choose, 16, 64
        st = rdma.new_factor_state(dist2d.init_local_pools(
            plan, lu.dplan, lu._a3_data, np.float32, cuda), ft)
        for level in range(ft.nlvl):
            for kern, plain in (
                    (lambda s: rdma.rdma_diag(s, th, ft, level),
                     lambda s: rdma.rdma_diag_plain(s, th, ft, level)),
                    (lambda s: rdma.rdma_panel(s, ft, level, wide),
                     lambda s: rdma.rdma_panel_plain(s, ft, level)),
                    (lambda s: rdma.rdma_schur(s, ft, level, wide),
                     lambda s: rdma.rdma_schur_plain(s, ft, level))):
                ref = rdma.FactorState.of(
                    [t.clone() for t in st.tensors()], ft.ndev)
                kern(st)
                plain(ref)
                close(st.tensors(), ref.tensors())
    tapes2 = [rdma.build_sweep_tapes(plan, lu.dplan, w, cuda, chunk=2)
              for w in "LU"]
    ttapes = [rdma.build_sweep_tapes(plan, lu.dplan, w, cuda)
              for w in ("UT", "LT")]
    assert any((np.diff(tp.host["chunkptr"]) > 1).any()
               for tp in (lu._lt, lu._ut))
    for nrhs in (1, 3, 9):
        B = torch.randn(plan.nb, plan.bs, nrhs, device=cuda)
        for tp, dinv in ((lu._lt, lu.linv), (lu._ut, lu.uinv),
                         (tapes2[0], lu.linv), (tapes2[1], lu.uinv),
                         (ttapes[0], lu.uinv), (ttapes[1], lu.linv)):
            ss = rdma.new_sweep_state([B.clone() for _ in lu.pool], tp)
            for level in range(tp.nlvl):
                for kern, plain, M in (
                        (rdma.rdma_solve_chunks,
                         rdma.rdma_solve_chunks_plain, lu.pool),
                        (rdma.rdma_solve_sum, rdma.rdma_solve_sum_plain,
                         lu.pool),
                        (rdma.rdma_solve_diag, rdma.rdma_solve_diag_plain,
                         dinv)):
                    ref = rdma.SweepState.of(
                        [t.clone() for t in ss.tensors()], tp.ndev)
                    kern(M, ss, tp, level)
                    plain(M, ref, tp, level)
                    close(ss.tensors(), ref.tensors())
            for k, v in rdma.stacked_recv(ss.recv, pr, pc,
                                          rdma.SOLVE_RECV).items():
                assert np.array_equal(v, tp.recv[k]), (tp.which, k)



GDTYPES = {"f64": "float64", "c64": "complex64", "c128": "complex128"}


def _grid_matrix(dt):
    """lap3d12 unsymmetric, or its complex twin with unit phases."""
    return _complex_unsym(12) if dt.startswith("complex") else \
        tt.laplacian_3d_unsym(12).tocsc()


def _tensor_eps(dtype):
    return float(np.finfo({torch.float32: np.float32,
                           torch.float64: np.float64,
                           torch.complex64: np.complex64,
                           torch.complex128: np.complex128}[dtype]).eps)


@pytest.mark.parametrize("sfx", list(GDTYPES))
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_rdma_types_match_plain(cuda, bs, sfx):
    """The 2D driver in float64, complex64 and complex128 on a 2x2 and a
    2x4 grid: a TRANS gssvx_dist with the condition estimate launches
    every entry of the RDMA factor and solve, through its ``_{sfx}``
    instantiation only, and agrees with the CPU run (x to 1e-12 relative,
    rcond to 1e-4 relative in complex64 and 1e-8 otherwise); every entry
    against its plain version level by level (the factor in the bands the
    kernels choose and in bands of 16; the L, U, Uᵀ and Lᵀ sweeps with one
    and five right-hand sides) within 64 ulp of the real type of the
    output's magnitude; the receive counters of the transposed sweeps
    equal to their tapes'; two factors and two transposed solves bit-equal
    (complex128 at bs 128 runs the diagonal tile in the pool)."""
    from superlu_dist_tpu_torch.parallel import dist2d
    dt = GDTYPES[sfx]
    A = _grid_matrix(dt)
    n = A.shape[0]
    rng = np.random.default_rng(bs)
    b = rng.standard_normal(n) + (1j * rng.standard_normal(n)
                                  if dt.startswith("complex") else 0)
    for pr, pc in ((2, 2), (2, 4)):
        opts = T.Options(dtype=dt, block_size=bs, trans=T.Trans.TRANS,
                         condition_number=True)
        for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
            k.reset_counts()
        rg, lu = T.gssvx_dist(A, b, T.Grid2D(pr, pc), opts, device=cuda)
        for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
            assert all((v > 0) == e.endswith(f"_{sfx}")
                       for e, v in k.entry_launches.items()), \
                k.entry_launches
        rc, _ = T.gssvx_dist(A, b, T.Grid2D(pr, pc), opts, device="cpu")
        assert rg.berr.max() < 1e-15
        assert np.abs(rg.x - rc.x).max() <= 1e-12 * np.abs(rc.x).max()
        rtol = 1e-4 if dt == "complex64" else 1e-8
        assert abs(rg.rcond - rc.rcond) <= rtol * rc.rcond
        for got, tp in zip(lu.solve_recv(transpose=True), lu._ttapes):
            for k, v in got.items():
                assert np.array_equal(v, tp.recv[k]), (tp.which, k)
    eps = _tensor_eps(lu.pool[0].dtype)

    def close(a, p):
        torch.cuda.synchronize()
        for x, y in zip(a, p):
            if not (x.is_floating_point() or x.is_complex()):
                assert torch.equal(x, y)
                continue
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= ULPS * eps * scale

    ft, plan = lu._ft, lu.plan
    th = lu._thresh()
    pools0 = dist2d.init_local_pools(plan, lu.dplan, lu._a3_data, lu.dtype,
                                     cuda)
    for wide in (-1, 0):
        st = rdma.new_factor_state([p.clone() for p in pools0], ft)
        for level in range(ft.nlvl):
            for kern, plain in (
                    (lambda s: rdma.rdma_diag(s, th, ft, level),
                     lambda s: rdma.rdma_diag_plain(s, th, ft, level)),
                    (lambda s: rdma.rdma_panel(s, ft, level, wide),
                     lambda s: rdma.rdma_panel_plain(s, ft, level)),
                    (lambda s: rdma.rdma_schur(s, ft, level, wide),
                     lambda s: rdma.rdma_schur_plain(s, ft, level))):
                ref = rdma.FactorState.of(
                    [t.clone() for t in st.tensors()], ft.ndev)
                kern(st)
                plain(ref)
                close(st.tensors(), ref.tensors())
    f1, f2 = (rdma.rdma_factor([p.clone() for p in pools0], th, ft)
              for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(f1.tensors(),
                                                 f2.tensors()))
    lt, ut = lu._ttapes
    for nrhs in (1, 5):
        B = torch.randn(plan.nb, plan.bs, nrhs, device=cuda,
                        dtype=lu.pool[0].dtype)
        for tp, dinv in ((lu._lt, lu.linv), (lu._ut, lu.uinv),
                         (ut, lu.uinv), (lt, lu.linv)):
            ss = rdma.new_sweep_state([B.clone() for _ in lu.pool], tp)
            for level in range(tp.nlvl):
                for kern, plain, M in (
                        (rdma.rdma_solve_chunks,
                         rdma.rdma_solve_chunks_plain, lu.pool),
                        (rdma.rdma_solve_sum, rdma.rdma_solve_sum_plain,
                         lu.pool),
                        (rdma.rdma_solve_diag, rdma.rdma_solve_diag_plain,
                         dinv)):
                    ref = rdma.SweepState.of(
                        [t.clone() for t in ss.tensors()], tp.ndev)
                    kern(M, ss, tp, level)
                    plain(M, ref, tp, level)
                    close(ss.tensors(), ref.tensors())
            for k, v in rdma.stacked_recv(ss.recv, pr, pc,
                                          rdma.SOLVE_RECV).items():
                assert np.array_equal(v, tp.recv[k]), (tp.which, k)
        X1, X2 = (rdma.rdma_solve(lu.pool, lu.linv, lu.uinv, lt, ut, B)[0]
                  for _ in range(2))
        assert torch.equal(X1, X2)


@pytest.mark.parametrize("mode", ["replicated", "zsplit"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_rdma3d_kernels_match_plain(cuda, bs, mode):
    """The 3D driver on the card (Grid3D(2, 2, 2) and (2, 1, 2), both
    anc25d modes): a float32 gssvx3d launches every ``_f32`` entry of the
    RDMA factor and solve and no other, agrees with the CPU run (1e-10
    relative), and its receive counters equal the 3D tapes; then every
    entry against its plain version level by level on the 3D tapes (the
    ancestor reduction and zsplit's delta between the levels, the same on
    both), in the bands the kernels choose and in bands of 16, and the
    L, U, Uᵀ and Lᵀ sweeps (partials from every layer) with one and three
    right-hand sides, within 64 float32 ulp of the output's magnitude;
    the sweeps' receive counts equal their tapes; two factors bit-equal."""
    from superlu_dist_tpu_torch.parallel import dist3d
    A = tt.laplacian_3d(12).tocsc()
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    opts = T.Options(dtype="float32", block_size=bs, anc25d=mode)
    eps = np.finfo(np.float32).eps

    def close(a, p):
        torch.cuda.synchronize()
        for x, y in zip(a, p):
            if not x.is_floating_point():
                assert torch.equal(x, y)
                continue
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= ULPS * eps * scale

    for grid in ((2, 2, 2), (2, 1, 2)):
        for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
            k.reset_counts()
        rg, lu = T.gssvx3d(A, b, T.Grid3D(*grid), opts, device=cuda)
        for k in (rdma.RDMA_FACTOR, rdma.RDMA_SOLVE):
            assert all((v > 0) == e.endswith("_f32")
                       for e, v in k.entry_launches.items()), \
                k.entry_launches
        rc, _ = T.gssvx3d(A, b, T.Grid3D(*grid), opts, device="cpu")
        assert rg.berr.max() < 1e-15
        assert np.abs(rg.x - rc.x).max() <= 1e-10 * np.abs(rc.x).max()
        assert rg.stat.tiny_pivots == rc.stat.tiny_pivots
        for k, v in lu.factor_recv().items():
            assert np.array_equal(v, lu._ft.recv[k]), k
        for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
            for k, v in got.items():
                assert np.array_equal(v, tp.recv[k]), (tp.which, k)
    ft, plan, th = lu._ft, lu.plan, lu._thresh()
    assert ft.zsplit == (mode == "zsplit")
    for wide in (-1, 0):
        st = rdma.new_factor_state(lu._pools0(), ft)
        for level in range(ft.nlvl):
            dist3d.before_level(st, ft, level)
            for kern, plain in (
                    (lambda s: rdma.rdma_diag(s, th, ft, level),
                     lambda s: rdma.rdma_diag_plain(s, th, ft, level)),
                    (lambda s: rdma.rdma_panel(s, ft, level, wide),
                     lambda s: rdma.rdma_panel_plain(s, ft, level)),
                    (lambda s: rdma.rdma_schur(s, ft, level, wide),
                     lambda s: rdma.rdma_schur_plain(s, ft, level))):
                ref = rdma.FactorState.of(
                    [t.clone() for t in st.tensors()], ft.ndev)
                kern(st)
                plain(ref)
                close(st.tensors(), ref.tensors())
            dist3d.after_level(st, ft, level)
    f1, f2 = (dist3d.rdma_factor3d(lu._pools0(), th, ft)[0]
              for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(f1.tensors(),
                                                 f2.tensors()))
    lu.solve_transposed(b)
    lt, ut = lu._ttapes
    for nrhs in (1, 3):
        B = torch.randn(plan.nb, plan.bs, nrhs, device=cuda)
        for tp, dinv in ((lu._lt, lu.linv), (lu._ut, lu.uinv),
                         (ut, lu.uinv), (lt, lu.linv)):
            assert tp.pz == 2 and tp.npeer == 2 * (tp.pr if tp.transpose
                                                   else tp.pc)
            ss = rdma.new_sweep_state([B.clone() for _ in lu.pool], tp)
            for level in range(tp.nlvl):
                for kern, plain, M in (
                        (rdma.rdma_solve_chunks,
                         rdma.rdma_solve_chunks_plain, lu.pool),
                        (rdma.rdma_solve_sum, rdma.rdma_solve_sum_plain,
                         lu.pool),
                        (rdma.rdma_solve_diag, rdma.rdma_solve_diag_plain,
                         dinv)):
                    ref = rdma.SweepState.of(
                        [t.clone() for t in ss.tensors()], tp.ndev)
                    kern(M, ss, tp, level)
                    plain(M, ref, tp, level)
                    close(ss.tensors(), ref.tensors())
            for k, v in rdma.stacked_recv(ss.recv, tp.pr, tp.pc,
                                          rdma.SOLVE_RECV, tp.pz).items():
                assert np.array_equal(v, tp.recv[k]), (tp.which, k)


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_rdma3d_one_layer_bit_equal_to_2d(cuda, dtype):
    """Grid3D(1, 2, 2) on the card runs the 2D grid's launches: its
    factors and x bit-equal to gssvx_dist on Grid2D(2, 2); and a
    Grid3D(2, 2, 2) gssvx3d in float64, complex64 and complex128 through
    those entries against its CPU run (1e-12 relative; complex64 1e-10)."""
    A = _grid_matrix(dtype) if dtype != "float32" else \
        tt.laplacian_3d(12).tocsc()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.shape[0]) + (
        1j * rng.standard_normal(A.shape[0]) if dtype[0] == "c" else 0)
    opts = T.Options(dtype=dtype, block_size=64)
    r3, l3 = T.gssvx3d(A, b, T.Grid3D(1, 2, 2), opts, device=cuda)
    r2, l2 = T.gssvx_dist(A, b, T.Grid2D(2, 2), opts, device=cuda)
    assert np.array_equal(r3.x, r2.x)
    assert all(torch.equal(p, q) for p, q in zip(l3.pool, l2.pool))
    if dtype == "float32":
        return
    for dt in ("float64", "complex64", "complex128"):
        A = _grid_matrix(dt)
        b = rng.standard_normal(A.shape[0]) + (
            1j * rng.standard_normal(A.shape[0]) if dt[0] == "c" else 0)
        o = T.Options(dtype=dt, block_size=64, anc25d="zsplit")
        rg, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), o, device=cuda)
        rc, _ = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), o, device="cpu")
        assert lu.pool[0].dtype == getattr(torch, dt)
        tol = 1e-10 if dt == "complex64" else 1e-12
        assert np.abs(rg.x - rc.x).max() <= tol * np.abs(rc.x).max()
        assert rg.berr.max() <= 1e-12


def test_rdma_profile_levels_on_the_card(cuda):
    """``DistributedSparseLU.profile_levels`` on the card: one row per
    level timed by CUDA events, every step counted once, and the profiled
    factors live (the solve meets the limits afterwards)."""
    A = tt.laplacian_3d(12).tocsc()
    b = np.asarray(A @ np.random.default_rng(3).standard_normal(A.shape[0]))
    lu = T.DistributedSparseLU(A, T.Grid2D(2, 2), T.Options(
        dtype="float64", block_size=64), device=cuda)
    rows = lu.profile_levels()
    assert len(rows) == lu.dplan.nlvl
    assert sum(r["steps"] for r in rows) == lu.plan.nb
    assert all(r["ms"] > 0 for r in rows)
    x, berr = lu.refine(b, lu.solve(b))
    assert berr.max() < 1e-15


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


# ---------------------------------------------------------------------------
# complex64 and complex128: the level executor's kernels in their complex
# instantiations (csrc/cplx.cuh's element type)
# ---------------------------------------------------------------------------

CDTYPES = [torch.complex64, torch.complex128]
CIDS = ["c64", "c128"]


def _ceps(dtype):
    """The unit roundoff of a complex dtype's real type."""
    return np.finfo(np.complex64 if dtype == torch.complex64
                    else np.complex128).eps


def _complex_unsym(k, seed=1):
    """``laplacian_3d_unsym(k)`` with helmholtz_3d's shift and every
    off-diagonal entry times a seeded unit phase: A, Aᵀ and Aᴴ all
    differ, on the 7-point pattern."""
    A = sp.coo_matrix(tt.laplacian_3d_unsym(k, seed=seed)).astype(
        np.complex128)
    off = A.row != A.col
    ph = np.exp(1j * np.random.default_rng(seed).uniform(
        0, 2 * np.pi, int(off.sum())))
    data = A.data.copy()
    data[off] *= ph
    data[~off] -= 2.0 + 0.5j
    return sp.csc_matrix((data, (A.row, A.col)), shape=A.shape)


def _complex_tiles(rng, n, bs, dtype):
    T_ = (rng.standard_normal((n, bs, bs)) + 1j * rng.standard_normal(
        (n, bs, bs)) + bs * np.eye(bs))
    return torch.as_tensor(T_).to(dtype)


@pytest.mark.parametrize("ntile", [1, 140], ids=["1tile", "140tiles"])
@pytest.mark.parametrize("dtype", CDTYPES, ids=CIDS)
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_complex_diag_lu_matches_plain(cuda, bs, dtype, ntile):
    """diag_lu's complex instantiations against ``lu_inv_plain`` (64 ulp
    of the real type, of scale), then with three tiny complex pivots,
    which keep their phase at modulus thresh and are counted. complex128
    at bs 128 runs the layout with the tile in the pool."""
    thresh = 1e-3
    eps = _ceps(dtype)
    rng = np.random.default_rng(bs + ntile)
    tiles = _complex_tiles(rng, ntile, bs, dtype).to(cuda)
    tiny_p = (1e-9 * (1 + 1j), -1e-9j, 0.0)
    for with_tiny in (False, True):
        T_ = tiles.clone()
        if with_tiny:
            for j, v in zip((5, 9, 12), tiny_p):
                T_[0, j, :j] = 0
                T_[0, :j, j] = 0
                T_[0, j, j] = v
        slots = torch.as_tensor(rng.permutation(ntile + 3)[:ntile] + 1,
                                dtype=torch.int32, device=cuda)
        steps = torch.as_tensor(rng.permutation(ntile), dtype=torch.int32,
                                device=cuda)
        pool = torch.zeros(ntile + 4, bs, bs, dtype=dtype, device=cuda)
        pool[slots.long()] = T_
        linv = torch.zeros(ntile, bs, bs, dtype=dtype, device=cuda)
        uinv = torch.zeros_like(linv)
        tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
        n0 = diag_lu.KERNEL.launches
        diag_lu.diag_lu(pool, linv, uinv, slots, steps, thresh, tiny)
        torch.cuda.synchronize()
        assert diag_lu.KERNEL.launches == n0 + 1
        LU, li, ui, nt = diag_lu.lu_inv_plain(T_, thresh)
        assert int(tiny.item()) == int(nt) == (3 if with_tiny else 0)
        got = (pool[slots.long()], linv[steps.long()], uinv[steps.long()])
        if with_tiny:
            for j, v in zip((5, 9, 12), tiny_p):
                p = complex(got[0][0, j, j])
                want = thresh * (v / abs(v) if v else 1.0)
                assert abs(p - want) <= 4 * eps * thresh
        first = 1 if with_tiny else 0
        for g, p in zip(got, (LU, li, ui)):
            if ntile > first:
                scale = max(1.0, float(p[first:].abs().max()))
                assert float((g[first:] - p[first:]).abs().max()) \
                    <= ULPS * eps * scale


@pytest.mark.parametrize("dtype", CDTYPES, ids=CIDS)
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_complex_kernels_match_plain(cuda, bs, dtype):
    """A complex gssvx runs the level executor in its complex
    instantiations; its factor (diag_lu, trsm with both flags, schur in
    the bands the kernel chooses and in bands of 16) against the plain
    phases, then the L+U sweep and solve_gemm / diag_apply with both
    flags level by level (one and nine right-hand sides), all at 64 ulp
    of the real type; two factors and two transposed solves bit-equal."""
    A = _complex_unsym(12)
    b = np.random.default_rng(0).standard_normal(A.shape[0]) + 0j
    kern = (diag_lu.KERNEL, schur.SCHUR, schur.TRSM, solve_gemm.SWEEP)
    for k in kern + (clk.UPDATE, flk.KERNEL):
        k.reset_counts()
    name = "complex64" if dtype == torch.complex64 else "complex128"
    sfx = "c64" if dtype == torch.complex64 else "c128"
    res, lu = T.gssvx(A, b, T.Options(dtype=name, block_size=bs),
                      device=cuda)
    assert res.stat.counters["executor"] == "pallas"
    assert res.berr.max() < 1e-15
    assert lu.pool.dtype == dtype
    for k in kern:
        assert k.launches > 0, k.name
        assert all(v == 0 for e, v in k.entry_launches.items()
                   if not e.endswith(sfx)), k.entry_launches
    assert clk.UPDATE.launches == flk.KERNEL.launches == 0
    eps = _ceps(dtype)
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, lu.dtype, cuda)
    ref = _level_plain(pool.clone(), lu._thresh(), tp, plan.nb)
    f1 = schur.factor(pool.clone(), lu._thresh(), tp, plan.nb)
    f2 = schur.factor(pool.clone(), lu._thresh(), tp, plan.nb)
    for x, y in zip(f1, f2):
        assert torch.equal(x, y)
    for got in (f1, _level_kernel(pool.clone(), lu._thresh(), tp, plan.nb,
                                  0)):
        for k, p in zip(got[:3], ref[:3]):
            scale = max(1.0, float(p.abs().max()))
            assert float((k - p).abs().max()) <= ULPS * eps * scale
    for transpose in (False, True):
        tapes = (((solve_gemm.build_trans_tape(plan, "U", cuda), lu.uinv),
                  (solve_gemm.build_trans_tape(plan, "L", cuda), lu.linv))
                 if transpose else ((lu._ltape, lu.linv),
                                    (lu._utape, lu.uinv)))
        for nrhs in (1, 9):
            X = torch.randn(plan.nb, plan.bs, nrhs, device=cuda, dtype=dtype)
            X0 = X.clone()
            for tape, dinv in tapes:
                for level in range(tape.nlvl):
                    Xp = X.clone()
                    solve_gemm.solve_level(lu.pool, dinv, X, tape, level,
                                           transpose)
                    solve_gemm.solve_level_plain(lu.pool, dinv, Xp, tape,
                                                 level, transpose)
                    torch.cuda.synchronize()
                    scale = max(1.0, float(Xp.abs().max()))
                    assert float((X - Xp).abs().max()) <= ULPS * eps * scale
            if transpose:
                tu, tl = (t for t, _ in tapes)
                X1, X2 = (solve_gemm.solve_transposed(
                    lu.pool, lu.uinv, lu.linv, tu, tl, X0.clone())
                    for _ in range(2))
                assert torch.equal(X1, X2)


def test_complex_gssvx_matches_cpu(cuda):
    """complex64 and complex128 ``gssvx`` on the card (NOTRANS, TRANS and
    CONJ with the condition estimate) against the same calls on the CPU:
    x to 1e-12 relative, berr below 1e-15, rcond to 1e-4 relative in
    complex64 (the estimate runs unrefined solves, which carry the factor's
    rounding) and 1e-8 in complex128."""
    A = _complex_unsym(10, seed=3)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(
        A.shape[0])
    for dt in ("complex64", "complex128"):
        for trans, op in ((T.Trans.NOTRANS, A), (T.Trans.TRANS, A.T),
                          (T.Trans.CONJ, A.conj().T)):
            opts = T.Options(dtype=dt, block_size=64, trans=trans,
                             condition_number=True)
            rg, _ = T.gssvx(A, b, opts, device=cuda)
            rc, _ = T.gssvx(A, b, opts, device="cpu")
            assert rg.berr.max() < 1e-15 and rc.berr.max() < 1e-15
            assert np.abs(rg.x - rc.x).max() <= 1e-12 * np.abs(rc.x).max()
            assert np.abs(op @ rg.x - b).max() / np.abs(b).max() < 1e-12
            rtol = 1e-4 if dt == "complex64" else 1e-8
            assert abs(rg.rcond - rc.rcond) <= rtol * rc.rcond


def test_complex_without_instantiation_raises(cuda):
    """A complex CUDA tensor that reaches a wrapper without a complex
    instantiation raises; it never falls through to a plain version."""
    A = _complex_unsym(6)
    _, lu = T.gssvx(A, np.ones(A.shape[0]) + 0j, T.Options(
        dtype="complex64", block_size=32), device=cuda)
    plan = lu.plan
    pool = lu.pool.clone()
    ctp = clk.build_clk_tapes(plan, cuda)
    with pytest.raises(ValueError, match="float32"):
        clk.clk_trsm(pool, lu.uinv, ctp, 0)
    with pytest.raises(ValueError, match="float32"):
        clk.clk_update(pool, lu.linv, ctp, 0)
    ftp = flk.build_flk_tapes(plan, cuda)
    with pytest.raises(ValueError):
        flk.flk_update(pool, lu.linv, lu.uinv, ftp, 0)
    X = torch.zeros(plan.nb, plan.bs, 1, dtype=torch.complex32, device=cuda)
    with pytest.raises(ValueError, match="complex128"):
        solve_gemm.solve(lu.pool.to(torch.complex32), lu.linv, lu.uinv,
                         lu._ltape, lu._utape, X)


@pytest.mark.parametrize("equil", ["YES", "NO"])
@pytest.mark.parametrize("rowperm", ["NOROWPERM", "LARGE_DIAG_MC64"])
def test_pdtest_cross_product_single_on_the_card(cuda, equil, rowperm):
    """The single-device leg of ``tests/test_torch_pdtest.py`` on the card:
    fact (with the reuse staging) × nrhs ∈ {1, 3} in each equil × rowperm
    cell, float32 at bs 32 (the kernels' smallest block size), each config
    below THRESH with berr below 1e-10; in the NOROWPERM cells, whose
    solution fails the residual test in the reference too (that file says
    why), against the same config on the CPU: both fail the residual test
    with berr above 0.5, and both replace tiny pivots, as many within 10%
    (the pivots sit at the float32 threshold, so the card's other
    summation order moves a few of them across it: 32 against 34)."""
    from torch_pdtest import FACTS, NRHS, run_config
    A = tt.unsymmetric_pattern(120, seed=3)
    for fact in FACTS:
        for nrhs in NRHS:
            # the FP32 pass on both devices (the card's "auto" is
            # bf16-first, and escalates in the NOROWPERM cells)
            opts = T.Options(dtype="float32", block_size=32,
                             equil=getattr(T.Equil, equil),
                             row_perm=getattr(T.RowPerm, rowperm),
                             gemm_precision="highest")
            res, rt = run_config(T.gssvx, A, opts, fact, nrhs, device=cuda)
            what = (fact, equil, rowperm, nrhs)
            if rowperm != "NOROWPERM":
                assert rt < tt.THRESH, (what, rt)
                assert float(np.max(res.berr)) < 1e-10, what
                continue
            cres, crt = run_config(T.gssvx, A, opts, fact, nrhs,
                                   device="cpu")
            assert rt >= tt.THRESH and crt >= tt.THRESH, (what, rt, crt)
            assert float(np.min(res.berr)) > 0.5, what
            assert float(np.min(cres.berr)) > 0.5, what
            nt, cnt = res.stat.tiny_pivots, cres.stat.tiny_pivots
            # FACTORED factors nothing in its own call, so counts none
            assert (nt > 0 and cnt > 0) or fact == T.Fact.FACTORED, what
            assert abs(nt - cnt) <= 0.1 * cnt, (what, nt, cnt)


# ---------------------------------------------------------------------------
# the batch: the level executor's kernels and the sweep with a member axis
# ---------------------------------------------------------------------------

BATCH_DTYPES = [torch.float32, torch.float64, torch.complex64,
                torch.complex128]


def _batch_members(lu, count, seed=0):
    """``count`` pools on ``lu``'s plan: its input values, each entry
    times (1 + 0.1·N(0, 1)) of the member's seed (member 0 unchanged)."""
    pools = []
    for m in range(count):
        v = lu._a3_data.copy()
        if m:
            v = v * (1 + 0.1 * np.random.default_rng(seed + m)
                     .standard_normal(len(v)))
        pools.append(blocklu.init_pool(lu.plan, v, lu.dtype, lu.device))
    return torch.stack(pools)


@pytest.mark.parametrize("dtype", BATCH_DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("bs", [32, 64])
def test_batch_kernels_bit_equal_unbatched(cuda, bs, dtype):
    """``schur.factor_batch`` (diag_lu, trsm and schur with a member axis)
    and ``solve_gemm.solve_batch`` on three members: each member's pool,
    inverses, tiny count and solution bit-equal to the unbatched entries
    on that member alone, with one launch per level per phase for all
    members (the unbatched factor's count, made once)."""
    name = str(dtype)[6:]
    A = tt.helmholtz_3d(8).tocsc() if dtype.is_complex \
        else tt.laplacian_3d(10).tocsc()
    lu = T.SparseLU(A, T.Options(dtype=name, block_size=bs,
                                 executor="pallas"), device=cuda)
    plan, tp = lu.plan, lu._ftapes
    P = _batch_members(lu, 3)
    th = lu._thresh()
    thresh = torch.full((3,), th, dtype=P.real.dtype, device=cuda)
    kernels = (diag_lu.KERNEL, schur.SCHUR, schur.TRSM,
               diag_lu.DIAG_LU_BATCH, schur.SCHUR_BATCH, schur.TRSM_BATCH)
    for k in kernels:
        k.reset_counts()
    Pb, Lb, Ub, tb = schur.factor_batch(P.clone(), thresh, tp, plan.nb)
    batched = [k.launches for k in kernels[3:]]
    singles = [schur.factor(P[m].clone(), th, tp, plan.nb) for m in range(3)]
    assert batched == [k.launches // 3 for k in kernels[:3]]
    assert all(batched)
    for m, (p1, l1, u1, t1) in enumerate(singles):
        assert torch.equal(Pb[m], p1) and torch.equal(Lb[m], l1)
        assert torch.equal(Ub[m], u1) and int(tb[m]) == int(t1.item())
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.standard_normal((3, plan.nb, bs, 2)),
                        dtype=dtype, device=cuda)
    solve_gemm.SWEEP_BATCH.reset_counts()
    Xb = solve_gemm.solve_batch(Pb, Lb, Ub, lu._ltape, lu._utape, X.clone())
    assert solve_gemm.SWEEP_BATCH.launches > 0
    for m, (p1, l1, u1, _) in enumerate(singles):
        x1 = solve_gemm.solve(p1, l1, u1, lu._ltape, lu._utape, X[m].clone())
        assert torch.equal(Xb[m], x1)


def test_batch_member_past_2_31_elements(cuda):
    """A stacked float32 pool of three members of 66,000 slots at bs 128
    (3.2·10⁹ elements, 13 GB): the last member starts past 2³¹ elements.
    diag_lu and trsm with the member axis on a few of its slots (the
    last one among them) agree with the plain versions, and the members
    before it are left as they were."""
    bs, slots, m = 128, 66_000, 3
    assert 2 * slots * bs * bs > 2 ** 31
    P = torch.zeros((m, slots, bs, bs), dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(2)
    used = torch.tensor([0, 17, slots - 1], dtype=torch.int32, device=cuda)
    panel = torch.tensor([5, slots - 2], dtype=torch.int32, device=cuda)
    g = torch.as_tensor(rng.standard_normal((m, 5, bs, bs)),
                        dtype=torch.float32, device=cuda)
    g[:, :3] += bs * torch.eye(bs, device=cuda)
    P[:, used.long()] = g[:, :3]
    P[:, panel.long()] = g[:, 3:]
    before = P[:2].clone()
    linv = torch.zeros((m, 3, bs, bs), dtype=torch.float32, device=cuda)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(m, dtype=torch.int32, device=cuda)
    th = torch.full((m,), 1e-6, dtype=torch.float32, device=cuda)
    steps = torch.arange(3, dtype=torch.int32, device=cuda)
    last = P[m - 1].clone()
    li, ui = linv[m - 1].clone(), uinv[m - 1].clone()
    diag_lu.diag_lu_batch(P, linv, uinv, used, steps, th, tiny)
    diag_lu.diag_lu_plain(last, li, ui, used.long(), steps.long(), 1e-6,
                          torch.zeros(1, dtype=torch.int32, device=cuda))
    eps = float(np.finfo(np.float32).eps)

    def close(a, b):      # 64 ulp of scale, as test_diag_lu_matches_plain
        return float((a - b).abs().max()) <= ULPS * eps * max(1.0, float(
            b.abs().max()))

    assert close(P[m - 1][used.long()], last[used.long()])
    assert close(linv[m - 1], li) and close(uinv[m - 1], ui)
    pan = steps[:2]
    schur.trsm_batch(P, uinv, panel, pan, left=False)
    schur.trsm_plain(last, ui, panel.long(), pan.long(), left=False)
    assert close(P[m - 1][panel.long()], last[panel.long()])
    # members 0 and 1 went through the same launches on their own data
    assert not torch.equal(P[:2], before)
    del P, before, g


def test_batch_launches_in_chunks_of_members(cuda):
    """65,537 members (past gridDim.z's 65,535): diag_lu and trsm with the
    member axis launch twice, and every member, the last one included,
    agrees with the plain versions."""
    bs, m = 32, 65_537
    rng = np.random.default_rng(4)
    P = torch.as_tensor(rng.standard_normal((m, 2, bs, bs)),
                        dtype=torch.float32, device=cuda)
    P[:, 0] += bs * torch.eye(bs, device=cuda)
    P0 = P.clone()
    linv = torch.zeros((m, 1, bs, bs), dtype=torch.float32, device=cuda)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(m, dtype=torch.int32, device=cuda)
    th = torch.full((m,), 1e-6, dtype=torch.float32, device=cuda)
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    diag_lu.DIAG_LU_BATCH.reset_counts()
    schur.TRSM_BATCH.reset_counts()
    diag_lu.diag_lu_batch(P, linv, uinv, z, z, th, tiny)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    schur.trsm_batch(P, uinv, one, z, left=False)
    assert diag_lu.DIAG_LU_BATCH.launches == 2
    assert schur.TRSM_BATCH.launches == 2
    LU, li, ui, _ = diag_lu.lu_inv_plain(P0[:, 0], 1e-6)
    eps = float(np.finfo(np.float32).eps)
    want = P0[:, 1] @ ui
    for got, ref in ((P[:, 0], LU), (linv[:, 0], li), (uinv[:, 0], ui),
                     (P[:, 1], want)):
        assert float((got - ref).abs().max()) <= ULPS * eps * max(
            1.0, float(ref.abs().max()))
    assert int(tiny.sum()) == 0


def test_batched_sparse_lu_matches_cpu(cuda):
    """``BatchedSparseLU`` on the card against the same batch on the CPU
    (the plain versions): per-member factors within the float32 rule,
    refined X within 1e-10 and berr <= 1e-12 for every member, and the
    factor's launches those of one member's factor."""
    A0 = tt.laplacian_3d(10).tocsc()
    As = []
    for i in range(4):
        A = A0.copy()
        A.data = A.data * (1 + 0.1 * np.random.default_rng(i)
                           .standard_normal(A.nnz))
        As.append(A)
    n = A0.shape[0]
    B = np.stack([np.random.default_rng(20 + i).standard_normal(n)
                  for i in range(4)])
    o = T.Options(dtype="float32", block_size=64)
    diag_lu.DIAG_LU_BATCH.reset_counts()
    g = T.BatchedSparseLU(As, o, device=cuda)
    c = T.BatchedSparseLU(As, o, device="cpu")
    ns = g.plan.nslots
    pg, pc = g.pool_b[:, :ns].cpu(), c.pool_b[:, :ns]
    assert float((pg - pc).abs().max()) <= 1e-4 * max(1.0, float(
        pc.abs().max()))
    assert diag_lu.DIAG_LU_BATCH.launches == g.plan.n_flevels
    Xg, bg = g.refine(B, g.solve(B))
    Xc, bc = c.refine(B, c.solve(B))
    assert bg.max() <= 1e-12 and bc.max() <= 1e-12
    assert np.abs(Xg - Xc).max() <= 1e-10 * np.abs(Xc).max()


@pytest.mark.parametrize("executor", [None, "flk", "pallas", "tck"])
def test_embedded_gssvx_matches_cpu(cuda, executor, monkeypatch):
    """complex64 in the ring embedding (``SLU_TPU_COMPLEX=embed``) on the
    card through each float32 executor: NOTRANS, TRANS and CONJ refined
    to berr <= 1e-12 and within 1e-10 of the CPU run, logdet's phase
    within 1e-4 of numpy's slogdet."""
    monkeypatch.setenv("SLU_TPU_COMPLEX", "embed")
    A = tt.helmholtz_3d(8).tocsc()
    n = A.shape[0]
    rng = np.random.default_rng(3)
    xt = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    # the FP32 pass (logdet is held to slogdet at float32 rounding)
    o = T.Options(dtype="complex64", block_size=64, executor=executor,
                  gemm_precision="highest")
    sign, logabs = np.linalg.slogdet(A.toarray())
    for tr, op in (("NOTRANS", A), ("TRANS", A.T), ("CONJ", A.conj().T)):
        b = op @ xt
        oo = o.replace(trans=getattr(T.Trans, tr))
        rg, lg = T.gssvx(A, b, oo, device=cuda)
        rc, _ = T.gssvx(A, b, oo, device="cpu")
        assert lg._embed and lg.pool.dtype == torch.float32
        assert rg.berr.max() <= 1e-12
        assert np.abs(rg.x - rc.x).max() <= 1e-10 * np.abs(rc.x).max()
    s, la = lg.logdet()
    assert abs(s - sign) <= 1e-4 and abs(la - logabs) <= 1e-4 * abs(logabs)


# ---------------------------------------------------------------------------
# clk's bf16 pass (gemm_precision "default") and the escalation
# ---------------------------------------------------------------------------

#: clk_update_bf16 against its plain version: chip_smoke.py's BF16_TOL
#: (four bf16 ulps of scale; a sum that the two order differently can round
#: to the other neighbouring bf16 value inside the level), and the summed
#: distance below a tenth of the FP32 pass's (BF16_FRACTION)
BF16_TOL = 2.0 ** -6


def _wave_geoms(bs):
    """None (the launcher's own choice per wave), then every geometry
    (strip width, ring depth) that it may choose at ``bs``, forced."""
    return [None] + clk.wave_geom_choices(bs)


def _clk_waves(pool, linv, tp, level, geom):
    """clk_update at "default" (geom None), or its bf16 entry with the
    wave geometry ``geom`` forced on every wave."""
    if geom is None:
        clk.clk_update(pool, linv, tp, level, "default")
    else:
        clk.launch_waves(clk.UPDATE_BF16, "slu_clk_waves_bf16", pool, linv,
                         tp, level, geom)


def _finalize_only(tp):
    """Whether the wave tapes ``tp`` hold a target that is finalized with
    no product (np == 0), and the longest product list of one target
    (longer than one on lap3d12's tapes)."""
    cnt = np.diff(tp.host["pptr"])
    alone = (cnt == 0) & (tp.host["tfin"] == flk.FIN_U)
    return bool(alone.any()), int(cnt.max())


@pytest.mark.parametrize("mat", ["lap3d12", "random1", "random2"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_clk_bf16_entries_match_plain(cuda, bs, mat):
    """slu_clk_waves_bf16 and slu_clk_trsm_bf16 against clk_update_plain
    and clk_trsm_plain at "default", level by level from the same pool
    (random patterns: values that bf16 does not hold exactly): the update
    within BF16_TOL of scale at the launcher's own geometry and at every
    (strip width, ring depth) it may choose, each forced, all bit-equal
    (an output element sums the same products in the same order at every
    geometry); the TRSM (whose operands are its inputs) within ULPS; each
    closer to the bf16 plain version than the FP32 pass is, by ten times;
    the tapes hold a finalize alone (np == 0), lap3d12's lists longer than
    one;
    one launch per wave, geometry and level with L blocks, and none of the
    FP32 entries."""
    if mat == "lap3d12":
        A = tt.laplacian_3d(12).tocsc()
        _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
            dtype="float32", block_size=bs), device=cuda)
        plan, data = lu.plan, lu._a3_data
    else:
        A = _sym_random(6 * bs, 0.004 * int(mat[-1]), int(mat[-1]))
        plan, data = block_symbolic(A, bs), A.data
    tp = clk.build_clk_tapes(plan, cuda)
    alone, longest = _finalize_only(tp)
    assert alone and (longest > 1 or mat != "lap3d12")
    geoms = _wave_geoms(bs)
    pool = blocklu.init_pool(plan, data, np.float32, cuda)
    linv = torch.zeros((plan.nb, bs, bs), device=cuda)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=cuda)
    eps = np.finfo(np.float32).eps
    for k in (clk.UPDATE, clk.TRSM, clk.UPDATE_BF16, clk.TRSM_BF16):
        k.reset_counts()
    dist = {"update": [0.0, 0.0], "trsm": [0.0, 0.0]}
    ntrsm = 0
    for level in range(tp.nlvl):
        ref, hi = pool.clone(), pool.clone()
        clk.clk_update_plain(ref, linv, tp, level, "default")
        clk.clk_update_plain(hi, linv, tp, level, "highest")
        scale = max(1.0, float(ref.abs().max()))
        outs = []
        for g in geoms:
            out = pool.clone()
            _clk_waves(out, linv, tp, level, g)
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) <= BF16_TOL * scale, \
                (level, g)
            outs.append(out)
        for g, out in zip(geoms[1:], outs[1:]):
            assert torch.equal(out, outs[0]), (level, g)
        pool = outs[0]
        dist["update"][0] += float((pool - ref).abs().sum())
        dist["update"][1] += float((hi - ref).abs().sum())
        del outs, ref, hi
        lo, hi_ = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi_], tp.dstep[lo:hi_],
                        0.0, tiny)
        ref, hi = pool.clone(), pool.clone()
        clk.clk_trsm(pool, uinv, tp, level, "default")
        clk.clk_trsm_plain(ref, uinv, tp, level, "default")
        clk.clk_trsm_plain(hi, uinv, tp, level, "highest")
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.abs().max()))
        assert float((pool - ref).abs().max()) <= ULPS * eps * scale, level
        dist["trsm"][0] += float((pool - ref).abs().sum())
        dist["trsm"][1] += float((hi - ref).abs().sum())
        ntrsm += int(tp.lptr[level + 1] > tp.lptr[level])
    for kern, fp32 in dist.values():
        assert fp32 > 0 and kern <= 0.1 * fp32
    assert clk.UPDATE_BF16.launches == len(geoms) * int(tp.lwave[-1]) > 0
    assert clk.TRSM_BF16.launches == ntrsm > 0
    assert clk.UPDATE.launches == clk.TRSM.launches == 0


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_clk_bf16_waves_repeat_bit_equal(cuda, bs):
    """Two launches of slu_clk_waves_bf16 on the same input give the same
    bits, level by level, at the launcher's own geometry and at every one
    it may choose (no atomics, a fixed order)."""
    A = _sym_random(6 * bs, 0.008, 2)
    plan = block_symbolic(A, bs)
    tp = clk.build_clk_tapes(plan, cuda)
    pool = blocklu.init_pool(plan, A.data, np.float32, cuda)
    linv = torch.randn((plan.nb, bs, bs), device=cuda) / bs
    for level in range(tp.nlvl):
        for g in _wave_geoms(bs):
            a, b = pool.clone(), pool.clone()
            _clk_waves(a, linv, tp, level, g)
            _clk_waves(b, linv, tp, level, g)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (level, g)
        clk.clk_update(pool, linv, tp, level, "default")


def test_bf16_first_gssvx_on_the_card(cuda):
    """On CUDA "auto" factors bf16-first: gssvx reports "default", runs
    the bf16 entries only and refines to berr <= 1e-12, within 1e-10 of
    the CPU's "highest" solution; "highest" runs the FP32 entries only,
    and its factor is the one that "auto" escalates to."""
    A = tt.laplacian_3d(16).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kernels = (clk.UPDATE, clk.TRSM, clk.UPDATE_BF16, clk.TRSM_BF16)
    rc, _ = T.gssvx(A, b, T.Options(dtype="float32", block_size=64),
                    device="cpu")
    assert rc.stat.counters["gemm_precision"] == "highest"
    for prec, want in (("auto", "default"), ("highest", "highest")):
        for k in kernels:
            k.reset_counts()
        rg, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=64,
                                         gemm_precision=prec), device=cuda)
        assert rg.stat.counters["gemm_precision"] == want
        assert "precision_escalated" not in rg.stat.counters
        low = want == "default"
        assert (clk.UPDATE_BF16.launches > 0) == low
        assert (clk.TRSM_BF16.launches > 0) == low
        assert (clk.UPDATE.launches > 0) != low
        assert (clk.TRSM.launches > 0) != low
        assert rg.berr.max() <= 1e-12
        assert np.abs(rg.x - rc.x).max() <= 1e-10 * np.abs(rc.x).max()
        assert np.abs(A @ rg.x - b).max() <= 1e-10 * np.abs(b).max()
        if low:
            lo = lu
    hi_pool = lu.pool.clone()
    lo._refactor_values("highest")
    assert torch.equal(lo.pool, hi_pool)


def test_escalation_on_the_card(cuda):
    """aniso2d(128) at bs 128 (anisotropy 1e-3): the bf16 factor leaves
    refinement stalled (on the CPU's plain versions at berr 4.6e-3 after
    two steps), so "auto" re-factors at "highest" (precision_escalated,
    berr <= 1e-12), and a SamePattern_SameRowPerm refactor starts there
    (the FP32 entries only); an explicit "bf16" never escalates. (At
    k = 64 this right-hand side's bf16 refinement converges slowly, in
    20 steps, and does not stall.)"""
    A = tt.aniso2d(128).tocsc()
    b = np.asarray(A @ np.random.default_rng(1).standard_normal(A.shape[0]))
    o = T.Options(dtype="float32", block_size=128)
    res, lu = T.gssvx(A, b, o, device=cuda)
    assert res.stat.counters["precision_escalated"] == 1
    assert res.stat.counters["gemm_precision"] == "highest"
    assert res.berr.max() <= 1e-12
    for k in (clk.UPDATE, clk.UPDATE_BF16):
        k.reset_counts()
    A2 = A.copy()
    A2.data = A2.data * 1.25
    res, lu = T.gssvx(A2, b, o.replace(fact=T.Fact.SAME_PATTERN_SAME_ROWPERM),
                      lu=lu)
    assert res.stat.counters["gemm_precision"] == "highest"
    assert "precision_escalated" not in res.stat.counters
    assert clk.UPDATE.launches > 0 and clk.UPDATE_BF16.launches == 0
    assert res.berr.max() <= 1e-12
    lb = T.SparseLU(A, o.replace(gemm_precision="bf16"), device=cuda)
    _, berr = lb.refine(b, lb.solve(b))
    assert "precision_escalated" not in lb.stat.counters
    assert lb._gemm_prec_used == "default" and berr.max() > 1e-12


# ---------------------------------------------------------------------------
# tck's and flk's bf16 pass (ROADMAP.md item 2b)
# ---------------------------------------------------------------------------


def _bf16_plan(cuda, mat, bs, executor):
    """The plan and input values of ``mat`` at block size ``bs``: lap3d12
    as ``executor`` plans it on the card, or a random symmetric pattern
    (values that bf16 does not hold exactly)."""
    if mat == "lap3d12":
        A = tt.laplacian_3d(12).tocsc()
        _, lu = T.gssvx(A, np.ones(A.shape[0]), T.Options(
            dtype="float32", block_size=bs, executor=executor), device=cuda)
        return lu.plan, lu._a3_data
    A = _sym_random(6 * bs, 0.004 * int(mat[-1]), int(mat[-1]))
    return block_symbolic(A, bs), A.data


def _bf16_step(pool, kern, plain, tol, dist):
    """Run the kernel on ``pool`` and its plain version at "default" and
    at "highest" on copies; hold the kernel within ``tol`` of scale of
    the bf16 plain version and add both distances to ``dist``."""
    ref, hi = pool.clone(), pool.clone()
    kern(pool)
    plain(ref, "default")
    plain(hi, "highest")
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    assert float((pool - ref).abs().max()) <= tol * scale
    dist[0] += float((pool - ref).abs().sum())
    dist[1] += float((hi - ref).abs().sum())


@pytest.mark.parametrize("mat", ["lap3d12", "random1", "random2"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_tck_bf16_entries_match_plain(cuda, bs, mat):
    """slu_tck_waves_bf16 (phase A) and slu_tck_chunks_bf16 /
    slu_tck_sum_bf16 (phase B: each position's chain cut into chunks, on
    passes.cuh's chain product) against tck_waves_plain and
    tck_chains_plain at "default", level by level from the same pool, on
    the automatic chunks and on chunks of one product, phase B in the
    bands the kernel chooses, in bands of 16 and in bands of 64: within
    BF16_TOL of scale (a finalize inside phase A re-rounds sums that the
    two order differently), each phase closer to the bf16 plain version
    than the FP32 pass is, by ten times; a second phase B from the same
    input bit-equal to the first; one launch per wave, per level with
    chunks and per level with positions of several chunks, and none of
    the FP32 entries."""
    plan, data = _bf16_plan(cuda, mat, bs, "tck")
    for chunk in (None, 1):
        tp = tck.build_tck_tapes(plan, cuda, chunk=chunk)
        c = tp.chains
        nq = int((np.diff(c.qptr) > 0).sum())
        nm = int((np.diff(c.mptr) > 0).sum())
        for wide in (-1, 0, 1):
            pool = blocklu.init_pool(plan, data, np.float32, cuda)
            linv, uinv, tiny = _zero_inverses(pool, plan.nb)
            for k in (tck.UPDATE, tck.UPDATE_BF16):
                k.reset_counts()
            dist = {"a": [0.0, 0.0], "b": [0.0, 0.0]}
            for level in range(tp.nlvl):
                _bf16_step(pool, lambda p: tck.tck_waves(p, linv, tp, level,
                                                         "default"),
                           lambda p, pr: tck.tck_waves_plain(
                               p, linv, tp, level, pr),
                           BF16_TOL, dist["a"])
                again = pool.clone()
                _bf16_step(pool, lambda p: tck.tck_chains(p, tp, level,
                                                          wide),
                           lambda p, pr: tck.tck_chains_plain(p, tp, level,
                                                              pr),
                           BF16_TOL, dist["b"])
                tck.tck_chains(again, tp, level, wide)
                assert torch.equal(again, pool), (chunk, wide, level)
                del again
                lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
                diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                tp.dstep[lo:hi], 0.0, tiny)
                clk.clk_trsm(pool, uinv, tp, level, "default")
            for kern, fp32 in dist.values():
                assert fp32 > 0 and kern <= 0.1 * fp32
            e = tck.UPDATE_BF16.entry_launches
            assert e["slu_tck_waves_bf16"] == int(tp.lwave[-1]) > 0
            assert e["slu_tck_chunks_bf16"] == 2 * nq > 0
            assert e["slu_tck_sum_bf16"] == 2 * nm
            assert nm > 0 or chunk is None
            assert tck.UPDATE.launches == 0


@pytest.mark.parametrize("mat", ["lap3d12", "random1"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_tck_bf16_waves_every_geometry(cuda, bs, mat):
    """slu_tck_waves_bf16 (phase A) against tck_waves_plain at "default",
    level by level from the same pool, at the launcher's own geometry and
    at every (strip width, ring depth) it may choose, each forced: within
    BF16_TOL of scale and all bit-equal; the tapes hold a finalize alone,
    lap3d12's lists longer than one."""
    plan, data = _bf16_plan(cuda, mat, bs, "tck")
    tp = tck.build_tck_tapes(plan, cuda)
    alone, longest = _finalize_only(tp)
    assert alone and (longest > 1 or mat != "lap3d12")
    geoms = _wave_geoms(bs)
    pool = blocklu.init_pool(plan, data, np.float32, cuda)
    linv, uinv, tiny = _zero_inverses(pool, plan.nb)
    tck.UPDATE_BF16.reset_counts()
    for level in range(tp.nlvl):
        ref = pool.clone()
        tck.tck_waves_plain(ref, linv, tp, level, "default")
        scale = max(1.0, float(ref.abs().max()))
        outs = []
        for g in geoms:
            out = pool.clone()
            if g is None:
                tck.tck_waves(out, linv, tp, level, "default")
            else:
                clk.launch_waves(tck.UPDATE_BF16, "slu_tck_waves_bf16", out,
                                 linv, tp, level, g)
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) <= BF16_TOL * scale, \
                (level, g)
            outs.append(out)
        for g, out in zip(geoms[1:], outs[1:]):
            assert torch.equal(out, outs[0]), (level, g)
        pool = outs[0]
        del outs, ref
        tck.tck_chains(pool, tp, level)
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        0.0, tiny)
        clk.clk_trsm(pool, uinv, tp, level, "default")
    e = tck.UPDATE_BF16.entry_launches
    assert e["slu_tck_waves_bf16"] == len(geoms) * int(tp.lwave[-1]) > 0


@pytest.mark.parametrize("mat", ["lap3d12", "random1", "random2"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_flk_bf16_entries_match_plain(cuda, bs, mat):
    """slu_flk_chunks_bf16 and slu_flk_sum_bf16 against flk_update_plain
    at "default", group by group from the same pool, on the automatic
    chunks and on chunks of one product (pass 2 on diagonal, L and U
    targets), each in the bands the kernel chooses, bands of 16 and bands
    of 64: within BF16_TOL of scale (a finalize rounds a sum that the two
    order differently), closer to the bf16 plain version than the FP32
    pass is, by ten times; a second launch from the same input bit-equal
    to the first; both entries launched, the FP32 ones not."""
    plan, data = _bf16_plan(cuda, mat, bs, "flk")
    for chunk in (None, 1):
        tp = flk.build_flk_tapes(plan, cuda, chunk=chunk)
        for wide in (-1, 0, 1):
            pool = blocklu.init_pool(plan, data, np.float32, cuda)
            linv, uinv, tiny = _zero_inverses(pool, plan.nb)
            for k in (flk.KERNEL, flk.KERNEL_BF16):
                k.reset_counts()
            dist = [0.0, 0.0]
            for level in range(tp.nlvl):
                for g in (2 * level, 2 * level + 1):
                    again = pool.clone()
                    _bf16_step(pool, lambda p: flk.flk_update(
                        p, linv, uinv, tp, g, wide, "default"),
                        lambda p, pr: flk.flk_update_plain(
                            p, linv, uinv, tp, g, pr), BF16_TOL, dist)
                    flk.flk_update(again, linv, uinv, tp, g, wide, "default")
                    assert torch.equal(again, pool), (chunk, wide, g)
                    del again
                    if g == 2 * level:
                        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
                        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                        tp.dstep[lo:hi], 0.0, tiny)
            assert dist[1] > 0 and dist[0] <= 0.1 * dist[1]
            e = flk.KERNEL_BF16.entry_launches
            assert all(v > 0 for v in e.values()), e
            assert flk.KERNEL.launches == 0


@pytest.mark.parametrize("kw", [dict(executor="tck"), dict(executor="flk"),
                                dict(ilu_level=1, max_refine_steps=60,
                                     refine_rthresh=1.0)],
                         ids=["tck", "flk", "ilu1"])
def test_bf16_first_fused_gssvx_on_the_card(cuda, kw):
    """On CUDA "auto" factors tck, flk and ILU(1) bf16-first: gssvx
    reports "default" (or "highest" with precision_escalated after a
    stall), launches the bf16 entries (the FP32 ones only for an
    escalation), refines to berr <= 1e-12 and a residual <= 1e-10, and a
    second call gives a bit-equal x in as many steps; "highest" runs the
    FP32 entries only, and its factor is the one that an escalation's
    re-factor computes, bit for bit."""
    A = tt.laplacian_3d(16).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    tckish = kw.get("executor") == "tck"
    fp32, low = ((tck.UPDATE, tck.UPDATE_BF16) if tckish
                 else (flk.KERNEL, flk.KERNEL_BF16))
    runs = {}
    for prec in ("auto", "auto", "highest"):
        for k in (fp32, low):
            k.reset_counts()
        o = T.Options(dtype="float32", block_size=64, gemm_precision=prec,
                      **kw)
        rg, lu = T.gssvx(A, b, o, device=cuda)
        esc = rg.stat.counters.get("precision_escalated") == 1
        want = "default" if prec == "auto" and not esc else "highest"
        assert rg.stat.counters["gemm_precision"] == want
        assert (low.launches > 0) == (prec == "auto")
        assert (fp32.launches > 0) == (prec == "highest" or esc)
        assert rg.berr.max() <= 1e-12
        assert np.abs(A @ rg.x - b).max() <= 1e-10 * np.abs(b).max()
        runs.setdefault(prec, []).append((rg, lu))
    (r1, lo), (r2, _) = runs["auto"]
    assert np.array_equal(r1.x, r2.x)
    assert r1.stat.refine_steps == r2.stat.refine_steps
    hi_pool = runs["highest"][0][1].pool.clone()
    lo._refactor_values("highest")
    assert torch.equal(lo.pool, hi_pool)


# ---- the package surface on the card ----------------------------------


def _surface_env():
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    site = [p for p in sys.path if "site-packages" in p]
    return repo, dict(os.environ, PYTHONPATH=os.pathsep.join([repo] + site))


def test_cbridge_consumer_on_the_card(cuda, tmp_path):
    """A plain C program through the bridge factors on the card (no
    "device" key), and its refined x is the in-process port's, bit for
    bit (the card's refinement repeats bit for bit)."""
    import subprocess

    from superlu_dist_tpu_torch.utils import cbridge
    from superlu_dist_tpu_torch.utils.io import read_matrix
    repo, env = _surface_env()
    path = tmp_path / "lap12.rua"
    tt.write_hb(path, tt.laplacian_3d(12).astype(np.float32))
    exe = cbridge.compile_program(cbridge.consumer_source(),
                                  str(tmp_path / "bridge_solve"))
    out = subprocess.run([exe, str(path), '{"dtype": "float32"}',
                          str(tmp_path / "x.bin")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout, out.stderr[-3000:])
    assert "CBRIDGE OK" in out.stdout
    A = read_matrix(path)
    lu = T.SparseLU(A, T.Options(dtype="float32"), device=cuda)
    assert lu.stat.counters["gemm_precision"] == "default"
    b = np.asarray(A @ np.ones(A.shape[0]))
    x, _ = lu.refine(b, lu.solve(b))
    assert np.array_equal(np.fromfile(tmp_path / "x.bin"), x)


def test_checklu_writelu_on_the_card(cuda, tmp_path, monkeypatch):
    """The env hooks on a card factor: the FP32 factor's L·U residual
    below 1e-4, and two factors' dumps equal."""
    from superlu_dist_tpu_torch.utils import debug
    A = tt.laplacian_3d(12)
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    for prec in ("auto", "highest"):
        paths = []
        for i in range(2):
            paths.append(tmp_path / f"{prec}{i}.npz")
            monkeypatch.setenv("SLU_TPU_WRITELU", str(paths[-1]))
            lu = T.SparseLU(A, T.Options(dtype="float32",
                                         gemm_precision=prec), device=cuda)
            r = lu.stat.counters["checklu_max_resid"]
            assert np.isfinite(r)
            if prec == "highest":
                assert r < 1e-4
        assert debug.compare_lu(*paths)
        z = np.load(paths[0])
        assert np.array_equal(z["pool"], lu.pool.cpu().numpy())


def test_prewarm_on_the_card(cuda):
    """prewarm builds every kernel library and warms the escalation's
    "highest" factor after a bf16-first one."""
    from superlu_dist_tpu_torch.utils.prewarm import prewarm
    info = prewarm(tt.laplacian_3d(12), T.Options(dtype="float32"),
                   device=cuda)
    assert info["escalation_warm_s"] > 0
    again = prewarm(tt.laplacian_3d(12), T.Options(
        dtype="float32", gemm_precision="highest"), device=cuda)
    assert again["escalation_warm_s"] == 0
    assert again["build_s"] < 5.0


def test_xprof_trace_on_the_card(cuda, tmp_path):
    """A fresh interpreter's gssvx under SLU_TPU_XPROF writes a trace with
    the phase spans and the main path's kernels as device events."""
    import json
    import os
    import subprocess
    import sys
    repo, env = _surface_env()
    code = ("import numpy as np\n"
            "from superlu_dist_tpu_torch import Options, gssvx\n"
            "from superlu_dist_tpu_torch.utils.testing import laplacian_3d\n"
            "A = laplacian_3d(12)\n"
            "gssvx(A, np.ones(A.shape[0]), Options(dtype='float32'))\n")
    env["SLU_TPU_XPROF"] = str(tmp_path / "trace")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    (f,) = [p for p in os.listdir(tmp_path / "trace")
            if p.endswith(".pt.trace.json")]
    with open(tmp_path / "trace" / f) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"slu:FACT", "slu:SOLVE", "slu:REFINE"} <= names
    kern = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    for k in ("diag_lu_kernel", "wave_mma_kernel", "trsm_mma_kernel",
              "chunk_kernel", "rows_kernel"):
        assert any(k in nm for nm in kern), k


@pytest.mark.parametrize("scenario", ["mesh2d", "planning3d"])
def test_two_processes_on_one_card(cuda, tmp_path, scenario):
    """Two processes of ``tests/torch_multihost.py`` split the grid's
    ranks on the card (CUDA IPC windows, host fences): x, refinement
    steps and every rank's pools bit-equal to one process's on the card,
    the receive counters equal to the tapes (in the workers)."""
    import torch_multihost as tm
    with tm.Workers(tmp_path, scenario, "cuda", timeout=300) as w:
        if scenario == "mesh2d":
            A, xt, b = tm.system(12)
            lu = T.DistributedSparseLU(A, T.Grid2D(2, 4),
                                       tm._opts("cuda"), device=cuda)
        else:
            A, xt, b = tm.system(10)
            lu = T.Distributed3DSparseLU(
                A, T.Grid3D(2, 2, 2),
                tm._planning_opts("cuda").replace(align_blocks="off"),
                device=cuda)
        x, _ = lu.refine(b, lu.solve(b))
        got = w.results()
    for r in got:
        assert np.array_equal(r["x"], x)
        assert int(r["steps"]) == lu.stat.refine_steps
        assert np.array_equal(r["pools"], tm.pools_of(lu))
