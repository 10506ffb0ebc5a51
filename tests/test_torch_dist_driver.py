"""The port's 2D distributed driver (``gssvx_dist``,
``DistributedSparseLU``) on the CPU, where every rank runs the plain
PyTorch versions of the RDMA kernels, against the JAX package's
``gssvx_dist`` (its default XLA executor, on the 8-device test mesh), the
single-device port and scipy.

Tolerances: x within 1e-10 relative and berr <= 1e-12 for the refined
float32 factor, as the single-device driver's tests hold it; refinement
steps equal or within one (the JAX package refines through its XLA
sweep, the port through the RDMA sweep, so the last step's float32
rounding may differ); the distributed factors within 1e-4·max(1,
max|pool|) of the single-device level executor's (float32, other
summation orders)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.models.dist_driver import DistributedSparseLU as JDist
from superlu_dist_tpu.models.dist_driver import gssvx_dist as j_gssvx_dist
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.utils.testing import random_sparse
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.utils.testing import laplacian_2d

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
    ("float64", "8b"), ("complex", "8b"), ("trans", "8a"),
    ("condition_number", "8a"), ("solve_transposed", "8a"),
    ("rcond_1", "8a"), ("profile_levels", "8c"), ("dist_planning", "10"),
    ("several_cards", "8d")])
def test_not_ported_raises_naming_its_item(what, item):
    A = laplacian_2d(6).tocsc()
    b = np.ones(A.shape[0])
    grid = T.Grid2D(2, 2)
    match = f"ROADMAP.md, queue 1 items? {item}"
    with pytest.raises(NotImplementedError, match=match):
        if what == "float64":
            T.gssvx_dist(A, b, grid, T.Options(dtype="float64"),
                         device="cpu")
        elif what == "complex":
            T.gssvx_dist(A.astype(np.complex128), b, grid, _opts(T),
                         device="cpu")
        elif what == "trans":
            T.gssvx_dist(A, b, grid, _opts(T, trans=T.Trans.TRANS),
                         device="cpu")
        elif what == "condition_number":
            T.gssvx_dist(A, b, grid, _opts(T, condition_number=True),
                         device="cpu")
        elif what == "dist_planning":
            T.gssvx_dist(A, b, grid, _opts(T, dist_planning=True),
                         device="cpu")
        elif what == "several_cards":
            T.Grid2D(1, 2, devices=["cpu", "meta"])
        else:
            lu = T.DistributedSparseLU(A, grid, _opts(T), device="cpu")
            {"solve_transposed": lambda: lu.solve_transposed(b),
             "rcond_1": lu.rcond_1,
             "profile_levels": lu.profile_levels}[what]()


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
