"""The port's 2D distributed driver (``gssvx_dist``,
``DistributedSparseLU``) on the CPU, where every rank runs the plain
PyTorch versions of the RDMA kernels, against the JAX package's
``gssvx_dist`` (its default XLA executor, on the 8-device test mesh), the
single-device port and scipy.

Tolerances: x within 1e-10 relative and berr <= 1e-12 for the refined
float32 and complex64 factors, as the single-device driver's tests hold
them, and within 1e-12 relative in float64 and complex128; refinement
steps equal or within one (the JAX package refines through its XLA
sweep, the port through the RDMA sweep, so the last step's rounding may
differ); the distributed factors within 1e-4·max(1, max|pool|) of the
reference's in float32 and complex64 (other summation orders), and
1e-12·max(1, max|pool|) in float64 and complex128; rcond within 1e-3
relative (tests/test_trans_cond.py's tolerance)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.models.dist_driver import DistributedSparseLU as JDist
from superlu_dist_tpu.models.dist_driver import gssvx_dist as j_gssvx_dist
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.utils.testing import random_sparse
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.utils.testing import laplacian_2d
from torch_state import numpy_state

BS = 16
CASES = {"lap2d12-2x2": (lambda: laplacian_2d(12), (2, 2)),
         "random_unsym-2x4": (lambda: random_sparse(150, density=0.04,
                                                    seed=7), (2, 4))}


def _opts(pkg, **kw):
    return pkg.Options(dtype="float32", block_size=BS, **kw)


@pytest.fixture(scope="module", params=list(CASES))
def jax_case(request):
    make, (pr, pc) = CASES[request.param]
    A = make().tocsc()
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    jres, jlu = j_gssvx_dist(A, b, JGrid2D(pr, pc), _opts(J))
    return A, b, (pr, pc), jres, jlu


@pytest.mark.parametrize("executor", ["rdma", "xla"])
def test_gssvx_dist_matches_jax(jax_case, executor):
    A, b, (pr, pc), jres, jlu = jax_case
    res, lu = T.gssvx_dist(A, b, T.Grid2D(pr, pc),
                           _opts(T, dist_executor=executor), device="cpu")
    assert lu.plan.nslots == jlu.plan.nslots
    assert np.array_equal(lu.colperm, jlu.colperm)
    assert lu.dplan.n_local == jlu.dplan.n_local
    assert np.abs(res.x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
    assert res.berr.max() <= 1e-12 and jres.berr.max() <= 1e-12
    assert abs(res.stat.refine_steps - jres.stat.refine_steps) <= 1
    assert res.stat.tiny_pivots == jres.stat.tiny_pivots
    assert res.stat.counters["executor"] == "rdma"
    assert res.stat.counters["dist_executor"] == executor
    assert res.stat.counters["factor_psum_bytes"] == \
        jres.stat.counters["factor_psum_bytes"]
    # the puts of the factor and of the last solve, as the tapes count them
    for k, v in lu.factor_recv().items():
        assert np.array_equal(v, lu._ft.recv[k]), k
    for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
        for k, v in got.items():
            assert np.array_equal(v, tp.recv[k]), (tp.which, k)


def test_diag_u_and_logdet_match_jax(jax_case):
    A, b, (pr, pc), jres, jlu = jax_case
    lu = T.DistributedSparseLU(A, T.Grid2D(pr, pc), _opts(T), device="cpu")
    du, jdu = lu.diag_u(), np.asarray(jlu.diag_u())
    assert np.abs(du - jdu).max() <= 1e-5 * np.abs(jdu).max()
    (s, ld), (js, jld) = lu.logdet(), jlu.logdet()
    # the JAX package's sign is a float product of ±1 ratios
    assert s == round(js) and abs(ld - jld) <= 1e-6 * abs(jld)


def test_exported_factors_match_single_device_level_executor(jax_case):
    """The distributed factors, gathered slot by slot into the single-
    device layout, against the single-device port's level executor on the
    same plan."""
    A, b, (pr, pc), _, _ = jax_case
    lu = T.DistributedSparseLU(A, T.Grid2D(pr, pc), _opts(T), device="cpu")
    one = T.SparseLU(A, _opts(T, executor="pallas"), device="cpu")
    assert one.plan.nslots == lu.plan.nslots
    assert np.array_equal(one.colperm, lu.colperm)
    pool, linv, uinv = lu._export_factors()
    ns = lu.plan.nslots
    scale = max(1.0, float(one.pool[:ns].abs().max()))
    for got, ref in ((pool[:ns], one.pool[:ns]), (linv, one.linv),
                     (uinv, one.uinv)):
        assert float((got - ref).abs().max()) <= 1e-4 * scale
    assert not pool[ns:].any()


def test_ilu_level_on_the_grid():
    A = random_sparse(128, density=0.06, seed=4, diag_dominant=True)
    b = np.asarray(A @ np.random.default_rng(1).standard_normal(128))
    jlu = JDist(A, JGrid2D(2, 4), _opts(J, ilu_level=1))
    lu = T.DistributedSparseLU(A, T.Grid2D(2, 4), _opts(T, ilu_level=1),
                               device="cpu")
    assert lu.plan.nslots == jlu.plan.nslots
    x, jx = lu.solve(b), jlu.solve(b)
    # the same incomplete factor: the float32 solves agree to roundoff
    assert np.abs(x - jx).max() <= 1e-4 * np.abs(jx).max()


def test_same_pattern_refactor_keeps_plan_and_tapes():
    A = laplacian_2d(12).tocsc()
    n = A.shape[0]
    b = np.asarray(A @ np.random.default_rng(2).standard_normal(n))
    res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 2), _opts(T), device="cpu")
    plan, ft = lu.plan, lu._ft
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * np.random.default_rng(3)
                         .standard_normal(A2.nnz))
    lu.refactor(A2, T.Fact.SAME_PATTERN_SAME_ROWPERM)
    assert lu.plan is plan and lu._ft is ft
    x, berr = lu.refine(b, lu.solve(b))
    ref = spla.spsolve(A2, b)
    assert berr.max() <= 1e-12
    assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()
    lu.refactor(A, T.Fact.SAME_PATTERN)
    x, berr = lu.refine(b, lu.solve(b))
    assert np.abs(x - res.x).max() <= 1e-10 * np.abs(res.x).max()


def test_save_load_round_trip(tmp_path):
    A = random_sparse(150, density=0.04, seed=7).tocsc()
    b = np.asarray(A @ np.random.default_rng(4).standard_normal(150))
    res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 4), _opts(T), device="cpu")
    path = tmp_path / "dist.npz"
    T.save_factors(lu, path)
    one = T.load_factors(path, device="cpu")
    assert type(one) is T.SparseLU
    x, berr = one.refine(b, one.solve(b))
    assert berr.max() <= 1e-12
    assert np.abs(x - res.x).max() <= 1e-10 * np.abs(res.x).max()
    # the transposed solve runs on the single-device copy
    xt = one.solve_transposed(b)
    assert np.abs(A.T @ xt - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("what,item", [
    ("dist_planning", "10"), ("several_cards", "8d"), ("grid3d", "8d"),
    ("grid3d_dist_planning", "10")])
def test_not_ported_raises_naming_its_item(what, item):
    """Item 8d still raises naming its item. Item 10 is ported: in one
    process ``dist_planning`` runs the ordinary plan, as the JAX package's
    does (its ``_dist_planning_active`` needs several processes), so those
    cases hold x to the JAX package's."""
    A = laplacian_2d(6).tocsc()
    b = np.ones(A.shape[0])
    grid = T.Grid2D(2, 2)
    if what == "dist_planning":
        res, lu = T.gssvx_dist(A, b, grid, _opts(T, dist_planning=True),
                               device="cpu")
        jres, jlu = j_gssvx_dist(A, b, JGrid2D(2, 2),
                                 _opts(J, dist_planning=True))
        assert np.array_equal(lu.colperm, jlu.colperm)
        assert lu.plan.nslots == jlu.plan.nslots
        assert np.abs(res.x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
        return
    if what == "grid3d_dist_planning":
        # the batch's composite on a 3D grid, with sharded planning
        from superlu_dist_tpu.models.batch import gssvx_batch as j_batch
        from superlu_dist_tpu.parallel.grid import Grid3D as JGrid3D
        res, _ = T.gssvx_batch([A], [b], _opts(T, dist_planning=True),
                               grid=T.Grid3D(2, 2, 2), device="cpu")
        jres, _ = j_batch([A], [b], _opts(J, dist_planning=True),
                          grid=JGrid3D(2, 2, 2))
        x, jx = res[0].x, jres[0].x
        assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
        return
    match = f"ROADMAP.md, queue 1 items? {item}"
    with pytest.raises(NotImplementedError, match=match):
        if what == "several_cards":
            T.Grid2D(1, 2, devices=["cpu", "meta"])
        else:
            # the batch's composite on a 3D grid whose ranks sit on
            # several devices
            T.gssvx_batch([A], [b], _opts(T), grid=T.Grid3D(
                2, 1, 1, devices=["cpu", "meta"]), device="cpu")


def _complex(A, seed=5):
    """A with seeded imaginary parts on every entry."""
    A = sp.csc_matrix(A, dtype=np.complex128)
    A.data = A.data + 0.5j * np.random.default_rng(seed).standard_normal(
        A.nnz)
    return A


def _typed(dtype, seed=7):
    """random_sparse(150), complex for a complex dtype, and a right-hand
    side of its type."""
    A = random_sparse(150, density=0.04, seed=seed).tocsc()
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(150)
    if dtype.startswith("complex"):
        A = _complex(A, seed)
        b = b + 1j * rng.standard_normal(150)
    return A, b


#: relative tolerance of x and of the factors in each dtype
XTOL = {"float32": 1e-10, "complex64": 1e-10, "float64": 1e-12,
        "complex128": 1e-12}
FTOL = {"float32": 1e-4, "complex64": 1e-4, "float64": 1e-12,
        "complex128": 1e-12}
TYPED = [(d, g) for d in ("float64", "complex64", "complex128")
         for g in ((2, 2), (2, 4))]


@pytest.fixture(scope="module", params=TYPED,
                ids=[f"{d}-{g[0]}x{g[1]}" for d, g in TYPED])
def jax_typed(request):
    dtype, (pr, pc) = request.param
    A, b = _typed(dtype)
    jres, jlu = j_gssvx_dist(A, b, JGrid2D(pr, pc),
                             J.Options(dtype=dtype, block_size=BS))
    res, lu = T.gssvx_dist(A, b, T.Grid2D(pr, pc),
                           T.Options(dtype=dtype, block_size=BS),
                           device="cpu")
    return dtype, A, b, jres, jlu, res, lu


def test_typed_gssvx_dist_matches_jax(jax_typed):
    """float64, complex64 and complex128 on the grid (the RDMA kernels'
    plain versions in that type) against the JAX package's grid (its XLA
    executor): x, berr, diag_u, the tiny-pivot count, logdet."""
    dtype, A, b, jres, jlu, res, lu = jax_typed
    assert lu.pool[0].dtype == getattr(torch, dtype)
    assert lu.plan.nslots == jlu.plan.nslots
    assert np.array_equal(lu.colperm, jlu.colperm)
    assert np.abs(res.x - jres.x).max() <= XTOL[dtype] * np.abs(jres.x).max()
    assert res.berr.max() <= 1e-12 and jres.berr.max() <= 1e-12
    assert abs(res.stat.refine_steps - jres.stat.refine_steps) <= 1
    assert res.stat.tiny_pivots == jres.stat.tiny_pivots
    assert res.stat.counters["executor"] == "rdma"
    assert np.abs(A @ res.x - b).max() <= 1e-12 * np.abs(b).max()
    du, jdu = lu.diag_u(), np.asarray(jlu.diag_u())
    assert np.abs(du - jdu).max() <= FTOL[dtype] * np.abs(jdu).max()
    (s, ld), (js, jld) = lu.logdet(), jlu.logdet()
    assert abs(s - js) <= 1e-4 and abs(ld - jld) <= 1e-6 * abs(jld)


def test_typed_factors_match_jax(jax_typed):
    """The per-rank factors, gathered into the single-device layout, slot
    by slot and step by step against the JAX package's gathered grid
    factors."""
    dtype, A, b, jres, jlu, res, lu = jax_typed
    pool, linv, uinv = (t.numpy() for t in lu._export_factors())
    jpool, jlinv, juinv = (np.asarray(t) for t in jlu._export_factors())
    ns, nb = lu.plan.nslots, lu.plan.nb
    tol = FTOL[dtype] * max(1.0, float(np.abs(jpool[:ns]).max()))
    assert pool.dtype == np.dtype(dtype)
    assert np.abs(pool[:ns] - jpool[:ns]).max() <= tol
    assert np.abs(linv - jlinv[:nb]).max() <= tol
    assert np.abs(uinv - juinv[:nb]).max() <= tol


TRANS_CASES = [("float32", (2, 4), "TRANS"), ("float64", (2, 2), "TRANS"),
               ("complex64", (2, 2), "CONJ"),
               ("complex128", (2, 4), "CONJ"),
               ("complex128", (2, 2), "TRANS")]


@pytest.mark.parametrize("dtype,grid,trans", TRANS_CASES,
                         ids=[f"{d}-{g[0]}x{g[1]}-{t}"
                              for d, g, t in TRANS_CASES])
def test_trans_and_condition_number_match_jax(dtype, grid, trans):
    """``gssvx_dist`` with ``Options.trans`` (the transposed sweeps and
    the residual of Aᵀ or Aᴴ) and ``condition_number`` against the JAX
    package's on the same grid: x, berr, rcond."""
    A, b = _typed(dtype, seed=11)
    jres, _ = j_gssvx_dist(A, b, JGrid2D(*grid), J.Options(
        dtype=dtype, block_size=BS, trans=getattr(J.Trans, trans),
        condition_number=True))
    res, lu = T.gssvx_dist(A, b, T.Grid2D(*grid), T.Options(
        dtype=dtype, block_size=BS, trans=getattr(T.Trans, trans),
        condition_number=True), device="cpu")
    op = A.T if trans == "TRANS" else A.conj().T
    assert np.abs(res.x - jres.x).max() <= XTOL[dtype] * np.abs(jres.x).max()
    assert np.abs(op @ res.x - b).max() <= 1e-12 * np.abs(b).max()
    assert res.berr.max() <= 1e-12
    assert np.isclose(res.rcond, jres.rcond, rtol=1e-3)
    assert "RCOND" in res.stat.utime
    # the transposed solves' puts, as their tapes count them
    for got, tp in zip(lu.solve_recv(transpose=True), lu._ttapes):
        assert tp.transpose
        for k, v in got.items():
            assert np.array_equal(v, tp.recv[k]), (tp.which, k)


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_trans_valid_after_refactor(dtype):
    """A SamePattern refactor that changes the row permutation drops the
    transposed tapes with the plan (tests/test_trans_cond.py:159-183: stale
    tapes gave err ~7e4 while NOTRANS stayed right)."""
    from superlu_dist_tpu.utils.testing import random_sparse as rs
    rng = np.random.default_rng(5)
    A = rs(96, density=0.08, seed=8, diag_dominant=False)
    if dtype.startswith("complex"):
        A = _complex(A)
    n = A.shape[0]
    lu = T.DistributedSparseLU(A, T.Grid2D(2, 4), T.Options(
        dtype=dtype, block_size=BS, row_perm=T.RowPerm.LARGE_DIAG_MC64),
        device="cpu")
    b = rng.standard_normal(n)
    lu.solve_transposed(b)       # builds and keeps the transposed tapes
    tapes, plan = lu._ttapes, lu.plan
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.8 * np.abs(rng.standard_normal(A.nnz)))
    lu.refactor(A2, fact=T.Fact.SAME_PATTERN)
    assert lu.plan is not plan and lu._ttapes is None
    xt_ref = spla.spsolve(sp.csc_matrix(A2.T), b)
    x = lu.solve_transposed(b)
    assert lu._ttapes is not tapes
    tol = 1e-3 if dtype == "float32" else 1e-10
    assert np.abs(x - xt_ref).max() / np.abs(xt_ref).max() < tol


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_reuse_modes_on_the_grid(dtype):
    """Every Fact reuse mode in float64 and complex128 on a 2x4 grid:
    SamePattern_SameRowPerm keeps the plan and every tape (the transposed
    ones too), SamePattern redoes the row matching, FACTORED solves with
    the factors as they are; each solution against scipy's."""
    A, b = _typed(dtype, seed=3)
    lu = T.DistributedSparseLU(A, T.Grid2D(2, 4),
                               T.Options(dtype=dtype, block_size=BS),
                               device="cpu")
    lu.solve_transposed(b)
    plan, ft, tt = lu.plan, lu._ft, lu._ttapes
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * np.random.default_rng(3)
                         .standard_normal(A2.nnz))
    lu.refactor(A2, T.Fact.SAME_PATTERN_SAME_ROWPERM)
    assert lu.plan is plan and lu._ft is ft and lu._ttapes is tt
    for M, fact in ((A2, None), (A, T.Fact.SAME_PATTERN)):
        if fact is not None:
            lu.refactor(M, fact)
        for op, trans in ((M, T.Trans.NOTRANS), (M.T, T.Trans.TRANS),
                          (M.conj().T, T.Trans.CONJ)):
            x, berr = lu.refine(b, lu.solve(b, trans=trans), trans=trans)
            ref = spla.spsolve(sp.csc_matrix(op), b)
            assert berr.max() <= 1e-12
            assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_save_typed_grid_loads_single_device(tmp_path, dtype):
    """``save_factors`` of a float64 or complex grid writes the gathered
    factors, which load as a single-device SparseLU and solve A, Aᵀ and
    Aᴴ."""
    A, b = _typed(dtype, seed=4)
    res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 4),
                           T.Options(dtype=dtype, block_size=BS),
                           device="cpu")
    path = tmp_path / "grid.npz"
    T.save_factors(lu, path)
    one = T.load_factors(path, device="cpu")
    assert type(one) is T.SparseLU and one.pool.dtype == lu.pool[0].dtype
    x, berr = one.refine(b, one.solve(b))
    assert berr.max() <= 1e-12
    assert np.abs(x - res.x).max() <= 1e-10 * np.abs(res.x).max()
    for op, trans in ((A.T, T.Trans.TRANS), (A.conj().T, T.Trans.CONJ)):
        x1 = one.solve(b, trans=trans)
        x2 = lu.solve(b, trans=trans)
        assert np.abs(x1 - x2).max() <= 1e-12 * np.abs(x2).max()
        assert np.abs(op @ x1 - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_profile_levels_on_the_grid(dtype):
    """``profile_levels``: one row per level, the work of each level
    summed over the ranks as the JAX package counts it from its partition
    (steps, L and U panels, Schur products), every step once, and the
    profiled factors live (tests/test_dist2d.py:174-186)."""
    from superlu_dist_tpu.parallel import dist2d as jd
    A = laplacian_2d(12).tocsc()
    if dtype.startswith("complex"):
        A = _complex(A)
    b = np.asarray(A @ np.ones(A.shape[0]))
    lu = T.DistributedSparseLU(A, T.Grid2D(2, 4),
                               T.Options(dtype=dtype, block_size=BS),
                               device="cpu")
    pool0 = lu.pool
    rows = lu.profile_levels()
    assert lu.pool is not pool0
    assert len(rows) == lu.dplan.nlvl
    assert sum(r["steps"] for r in rows) == lu.plan.nb
    assert all(r["ms"] >= 0 for r in rows)
    assert lu.stat.counters["profiled_levels"] == len(rows)
    jdp = jd.partition_plan(_jplan_of(lu), 2, 4)
    nl = jdp.nlvl
    for r in rows:
        lvl = r["level"]
        for key, f in (("steps", "dptr"), ("lpanels", "lptr"),
                       ("upanels", "uptr"), ("gemms", "gptr")):
            p = getattr(jdp, f).reshape(-1, nl + 1)
            assert r[key] == int((p[:, lvl + 1] - p[:, lvl]).sum()), key
    # the factors stay live
    assert np.abs(lu.solve(b) - 1).max() < (1e-5 if dtype == "float32"
                                            else 1e-12)


def _jplan_of(lu):
    """The port's plan as the JAX package's SymbolicPlan (the same
    fields)."""
    import dataclasses

    from superlu_dist_tpu.ops.host.symbolic import SymbolicPlan as JPlan
    return JPlan(**{f.name: getattr(lu.plan, f.name)
                    for f in dataclasses.fields(JPlan)})


def test_profile_levels_needs_input_values():
    """A grid restored from a state carries no factor input and refuses
    to profile."""
    A = laplacian_2d(8).tocsc()
    jlu = JDist(A, JGrid2D(2, 2), J.Options(dtype="float64", block_size=BS))
    state = numpy_state(jlu, T.Options(dtype="float64", block_size=BS))
    state.update(pool=np.asarray(jlu.pool), linv=np.asarray(jlu.linv),
                 uinv=np.asarray(jlu.uinv))
    lu = T.DistributedSparseLU.from_numpy_state(state, T.Grid2D(2, 2),
                                                device="cpu")
    b = np.asarray(A @ np.ones(A.shape[0]))
    assert np.abs(lu.solve(b) - 1).max() < 1e-12
    assert np.abs(lu.solve(b, trans="T") - spla.spsolve(A.T.tocsc(), b)) \
        .max() < 1e-12
    with pytest.raises(RuntimeError, match="input values"):
        lu.profile_levels()


def test_grid_checks():
    assert repr(T.Grid2D(2, 4)) == "Grid2D(2x4)"
    assert T.Grid2D(2, 4).shape == (2, 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        T.Grid2D(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="dist_executor"):
        T.gssvx_dist(laplacian_2d(6), np.ones(36), T.Grid2D(1, 2),
                     _opts(T, dist_executor="nccl"), device="cpu")
    # ranks all on one named device run there
    A = laplacian_2d(8).tocsc()
    b = np.asarray(A @ np.ones(64))
    res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 2, devices=["cpu"] * 4),
                           _opts(T))
    assert lu.device == torch.device("cpu") and res.berr.max() <= 1e-12
    assert all(p.device == lu.device for p in lu.pool)
