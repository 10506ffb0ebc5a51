"""The port's 3D communication-avoiding driver (``gssvx3d``,
``Distributed3DSparseLU``, ``parallel/dist3d.py``) on the CPU, where
every rank of the Pz × Pr × Pc grid runs the plain PyTorch versions of the
RDMA kernels, against the JAX package's 3D driver on its 8-device test
mesh (its ``shard_map`` executor), scipy, and the port's 2D grid.

Tolerances: the 3D plans, the trans plans, the forest partition, the
receive tapes and the DIST counters are equal; the exported canonical
pool and the inverse tables within 1e-4·max(1, max|JAX pool|) in float32
and complex64 (other summation orders: batched torch products against
XLA einsums, through the tile inverses and chains of a few dozen
products) and 1e-12·max(1, max|JAX pool|) in float64 and complex128;
refined x within 1e-10 relative (float32, complex64) and 1e-12 (float64,
complex128), berr <= 1e-12, refinement steps equal or within one (the two
packages' last sweep rounds differently); tiny-pivot counts equal; rcond
within 1e-3 relative (tests/test_trans_cond.py's tolerance)."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.models.batch import gssvx_batch as j_gssvx_batch
from superlu_dist_tpu.models.driver3d import \
    Distributed3DSparseLU as JDist3D
from superlu_dist_tpu.models.driver3d import gssvx3d as j_gssvx3d
from superlu_dist_tpu.ops.host.ordering import geometric_nd as j_nd
from superlu_dist_tpu.ops.host.symbolic import block_symbolic as j_symbolic
from superlu_dist_tpu.parallel import dist3d as jd3
from superlu_dist_tpu.parallel.grid import Grid3D as JGrid3D
from superlu_dist_tpu.utils.testing import random_sparse
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops.host.ordering import geometric_nd
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.parallel import dist3d as td3
from superlu_dist_tpu_torch.utils.testing import laplacian_2d, laplacian_3d

BS = 16
XTOL = {"float32": 1e-10, "complex64": 1e-10, "float64": 1e-12,
        "complex128": 1e-12}
FTOL = {"float32": 1e-4, "complex64": 1e-4, "float64": 1e-12,
        "complex128": 1e-12}
GRIDS = [(2, 2, 2), (2, 1, 2), (4, 1, 2)]
MODES = ["replicated", "zsplit"]
#: the counters of the JAX package's DIST phase (driver3d.py:58-101)
DIST_COUNTERS = ("factor_psum_bytes", "anc_reduce_bytes",
                 "solve_psum_bytes", "anc_steps",
                 "anc25d_zsplit_psum_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions launch thousands of tiny torch ops on 8 ranks;
    one intra-op thread keeps OpenMP's start-up off each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _complex(A, seed=5):
    """A with seeded imaginary parts on every entry."""
    A = sp.csc_matrix(A, dtype=np.complex128)
    A.data = A.data + 0.5j * np.random.default_rng(seed).standard_normal(
        A.nnz)
    return A


def _system(dtype, k=12, seed=0):
    """laplacian_2d(k) (complex for a complex dtype) and a right-hand side
    of its type."""
    A = laplacian_2d(k).tocsc()
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(A.shape[0])
    if dtype.startswith("complex"):
        A = _complex(A)
        b = b + 1j * rng.standard_normal(A.shape[0])
    return A, np.asarray(b)


def _opts(pkg, dtype="float32", **kw):
    return pkg.Options(dtype=dtype, block_size=BS, **kw)


def _counters(stat, pz):
    keys = DIST_COUNTERS + tuple(f"layer{z}_steps" for z in range(pz))
    return {k: stat.counters.get(k) for k in keys}


# ---------------------------------------------------------------------------
# the host side: partition, plans, tapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pz", [1, 2, 4, 8])
def test_partition_forest_matches_jax(pz):
    for A in (laplacian_2d(10), laplacian_2d(12), laplacian_3d(6)):
        plan, jplan = block_symbolic(A, 8), j_symbolic(A, 8)
        assert np.array_equal(td3.step_costs(plan), jd3.step_costs(jplan))
        assert np.array_equal(td3.partition_forest(plan, pz),
                              jd3.partition_forest(jplan, pz))


def _same(a, b, what):
    if isinstance(b, np.ndarray) or hasattr(b, "shape"):
        assert np.array_equal(np.asarray(a), np.asarray(b)), what
    else:
        assert a == b, what


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_plan3d_and_trans_plan_match_jax(grid, mode):
    """Every field of ``DistPlan3D`` and of ``DistTransPlan3D`` equal to
    the JAX package's, on a square and an unsymmetric pattern."""
    for A in (laplacian_2d(11), random_sparse(150, density=0.04, seed=7)):
        plan, jplan = block_symbolic(A, BS), j_symbolic(A, BS)
        dp = td3.partition_plan3d(plan, *grid, anc25d=mode)
        jdp = jd3.partition_plan3d(jplan, *grid, anc25d=mode)
        for f in dataclasses.fields(jdp):
            _same(getattr(dp, f.name), getattr(jdp, f.name), f.name)
        for i in (1, 4):
            assert dp.comm_volume(i, nrhs=3) == jdp.comm_volume(i, nrhs=3)
        tp = td3.trans_partition_plan3d(plan, dp)
        jtp = jd3.trans_partition_plan3d(jplan, jdp)
        for f in dataclasses.fields(jtp):
            _same(getattr(tp, f.name), getattr(jtp, f.name), f.name)


def test_recv_tapes_on_a_layer_equal_the_2d_grid():
    """With Pz = 1 the 3D receive tapes and job lists are the 2D grid's."""
    from superlu_dist_tpu_torch.parallel import dist2d as td
    from superlu_dist_tpu_torch.parallel import dist2d_rdma as tr
    plan = block_symbolic(laplacian_2d(12), BS)
    dp2 = td.partition_plan(plan, 2, 2)
    dp3 = td3.partition_plan3d(plan, 1, 2, 2)
    r2, r3 = tr.build_rdma_recv_tapes(plan, dp2), td3.recv_tapes3d(plan, dp3)
    ft2 = tr.build_factor_tapes(plan, dp2, "cpu")
    ft3 = td3.build_factor_tapes3d(plan, dp3, "cpu")
    for k in r2:
        assert np.array_equal(r2[k], r3[k][0]), k
    for k in ft2.host:
        assert np.array_equal(ft2.host[k], ft3.host[k]), k
    for w in ("L", "U", "LT", "UT"):
        s2 = tr.build_sweep_tapes(plan, dp2, w, "cpu")
        s3 = td3.build_sweep_tapes3d(plan, dp3, w, "cpu")
        for k in s2.host:
            assert np.array_equal(s2.host[k], s3.host[k]), (w, k)


# ---------------------------------------------------------------------------
# the driver against the JAX package's
# ---------------------------------------------------------------------------

TYPED = [("float32", (2, 2, 2)), ("float64", (2, 1, 2)),
         ("complex64", (4, 1, 2)), ("complex128", (2, 2, 2))]


@pytest.fixture(scope="module", params=[(d, g, m) for d, g in TYPED
                                        for m in MODES],
                ids=[f"{d}-{'x'.join(map(str, g))}-{m}" for d, g in TYPED
                     for m in MODES])
def jax_case(request):
    dtype, grid, mode = request.param
    A, b = _system(dtype)
    jres, jlu = j_gssvx3d(A, b, JGrid3D(*grid),
                          _opts(J, dtype, anc25d=mode))
    res, lu = T.gssvx3d(A, b, T.Grid3D(*grid), _opts(T, dtype, anc25d=mode),
                        device="cpu")
    return dtype, grid, A, b, jres, jlu, res, lu


def test_gssvx3d_matches_jax(jax_case):
    """x, berr, refinement steps, tiny pivots and the DIST counters
    against the JAX package's ``gssvx3d``; the puts' receive counts of the
    factor and of the last solve equal their tapes."""
    dtype, grid, A, b, jres, jlu, res, lu = jax_case
    assert lu.pool[0].dtype == getattr(torch, dtype)
    assert lu.plan.nslots == jlu.plan.nslots
    assert np.array_equal(lu.colperm, jlu.colperm)
    assert lu.dplan.n_local == jlu.dplan.n_local
    assert np.array_equal(lu.dplan.step_layer, jlu.dplan.step_layer)
    assert np.abs(res.x - jres.x).max() <= XTOL[dtype] * np.abs(jres.x).max()
    assert res.berr.max() <= 1e-12 and jres.berr.max() <= 1e-12
    assert abs(res.stat.refine_steps - jres.stat.refine_steps) <= 1
    assert res.stat.tiny_pivots == jres.stat.tiny_pivots
    assert _counters(res.stat, grid[0]) == _counters(jres.stat, grid[0])
    assert res.stat.counters["executor"] == "rdma"
    for k, v in lu.factor_recv().items():
        assert v.shape == (*grid, lu.dplan.nlvl)
        assert np.array_equal(v, lu._ft.recv[k]), k
    for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
        for k, v in got.items():
            assert np.array_equal(v, tp.recv[k]), (tp.which, k)


def test_factors_match_jax(jax_case):
    """The per-rank factors gathered into the canonical single-device
    layout (ancestors from layer 0), slot by slot, and the inverse tables
    step by step, against the JAX package's export."""
    dtype, grid, A, b, jres, jlu, res, lu = jax_case
    pool, linv, uinv = (t.numpy() for t in lu._export_factors())
    jpool, jlinv, juinv = (np.asarray(t) for t in jlu._export_factors())
    ns, nb = lu.plan.nslots, lu.plan.nb
    tol = FTOL[dtype] * max(1.0, float(np.abs(jpool[:ns]).max()))
    assert np.abs(pool[:ns] - jpool[:ns]).max() <= tol
    assert np.abs(linv - jlinv[:nb]).max() <= tol
    assert np.abs(uinv - juinv[:nb]).max() <= tol
    assert not pool[ns:].any()
    # every layer's ancestor replicas are equal after the factor
    dp, lay = lu.dplan, grid[1] * grid[2]
    anc = slice(2, 2 + dp.max_anc)
    for e in range(lay, len(lu.pool)):
        assert torch.equal(lu.pool[e][anc], lu.pool[e % lay][anc])


def _tiny_diag(A, rows, v=1e-6):
    A = A.tolil()
    for i in rows:
        A[i, i] = v
    return A.tocsc()


@pytest.mark.parametrize("mode", MODES)
def test_tiny_pivots_match_jax(mode):
    """Tiny diagonal entries in subtree and top steps (no row matching,
    no scaling): the replaced pivots counted as the JAX package counts
    them (the top's once, though every layer factors it)."""
    A = _tiny_diag(laplacian_2d(12), (0, 37, 90, 143))
    kw = dict(anc25d=mode, row_perm=J.RowPerm.NOROWPERM, equil=J.Equil.NO)
    jlu = JDist3D(A, JGrid3D(2, 2, 2), _opts(J, **kw))
    kw.update(row_perm=T.RowPerm.NOROWPERM, equil=T.Equil.NO)
    lu = T.Distributed3DSparseLU(A, T.Grid3D(2, 2, 2), _opts(T, **kw),
                                 device="cpu")
    assert jlu.stat.tiny_pivots >= 2
    assert lu.stat.tiny_pivots == jlu.stat.tiny_pivots
    pool, jpool = lu._export_factors()[0].numpy(), jlu._export_factors()[0]
    ns = lu.plan.nslots
    assert np.abs(pool[:ns] - jpool[:ns]).max() <= \
        1e-4 * max(1.0, float(np.abs(jpool[:ns]).max()))


def test_zsplit_matches_replicated():
    """Both top strategies give the same factors and solution (the JAX
    package's tests/test_anc25d.py on the port): zsplit reports its z-sum
    volume and shares the top's Schur products out over the layers."""
    A = random_sparse(200, density=0.05, seed=3)
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(200))
    xr = spla.spsolve(A.tocsc().astype(np.float64), b)
    lu_r = T.Distributed3DSparseLU(A, T.Grid3D(2, 2, 2), _opts(T),
                                   device="cpu")
    lu_z = T.Distributed3DSparseLU(A, T.Grid3D(2, 2, 2),
                                   _opts(T, anc25d="zsplit"), device="cpu")
    x_z = lu_z.solve(b)
    assert np.abs(x_z - xr).max() / np.abs(xr).max() < 1e-4
    n0 = lu_r.dplan.n_local
    assert lu_z._ft.ndelta == lu_z.dplan.max_tact > 0
    for pr_, pz_ in zip(lu_r.pool, lu_z.pool):
        assert pz_.shape[0] == n0 + lu_z._ft.ndelta
        assert torch.allclose(pr_, pz_[:n0], rtol=1e-3, atol=1e-4)
        assert not pz_[n0:].any()          # the delta rows end zeroed
    assert lu_z.stat.counters["anc25d_zsplit_psum_bytes"] > 0
    assert "anc25d_zsplit_psum_bytes" not in lu_r.stat.counters
    dp_r, dp_z = lu_r.dplan, lu_z.dplan
    top = slice(dp_r.max_p1, dp_r.max_p1 + dp_r.ntop + 1)

    def top_items(dp):
        p = dp.gptr[..., top]
        return int(np.sum(p[..., -1] - p[..., 0]))

    assert top_items(dp_z) <= top_items(dp_r) // 2 + dp_r.ntop * 8
    xt = lu_z.solve_transposed(np.asarray(A.T @ xr))
    assert np.abs(xt - xr).max() / np.abs(xr).max() < 1e-3
    _, berr = lu_z.refine(b, x_z)
    assert float(np.max(berr)) < 1e-13


@pytest.mark.parametrize("mode", MODES)
def test_trans_conj_and_condition_number(mode):
    """The transposed sweeps: TRANS in float64 against scipy's solve of
    Aᵀ, CONJ with ``condition_number`` in complex128 against the JAX
    package's gssvx3d (x and rcond), the Uᵀ and Lᵀ sweeps' receive counts
    equal to their tapes."""
    A, b = _system("float64", k=11)
    res, lu = T.gssvx3d(A, b, T.Grid3D(2, 1, 2), _opts(
        T, "float64", anc25d=mode, trans=T.Trans.TRANS), device="cpu")
    ref = spla.spsolve(A.T.tocsc(), b)
    assert np.abs(res.x - ref).max() <= 1e-12 * np.abs(ref).max()
    assert res.berr.max() <= 1e-12
    for got, tp in zip(lu.solve_recv(transpose=True), lu._ttapes):
        assert tp.transpose and tp.npeer == 2 * 1
        for k, v in got.items():
            assert np.array_equal(v, tp.recv[k]), (tp.which, k)
    A, b = _system("complex128", k=11)
    jres, _ = j_gssvx3d(A, b, JGrid3D(2, 2, 2), _opts(
        J, "complex128", anc25d=mode, trans=J.Trans.CONJ,
        condition_number=True))
    res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), _opts(
        T, "complex128", anc25d=mode, trans=T.Trans.CONJ,
        condition_number=True), device="cpu")
    assert np.abs(A.conj().T @ res.x - b).max() <= 1e-12 * np.abs(b).max()
    assert np.abs(res.x - jres.x).max() <= 1e-12 * np.abs(jres.x).max()
    assert abs(res.rcond - jres.rcond) <= 1e-3 * jres.rcond


def test_gssvx_batch_on_a_3d_grid():
    """``gssvx_batch(..., grid=Grid3D)`` factors the composite with the 3D
    driver, as the JAX package's does."""
    As = [laplacian_2d(7).tocsc(), random_sparse(60, density=0.08, seed=2)]
    rng = np.random.default_rng(3)
    Bs = [np.asarray(A @ rng.standard_normal(A.shape[0])) for A in As]
    res, lu = T.gssvx_batch(As, Bs, _opts(T), grid=T.Grid3D(2, 2, 2),
                            device="cpu")
    jres, _ = j_gssvx_batch(As, Bs, _opts(J), grid=JGrid3D(2, 2, 2))
    assert type(lu) is T.Distributed3DSparseLU
    for r, jr, A, b in zip(res, jres, As, Bs):
        assert r.berr.max() <= 1e-12
        assert np.abs(r.x - jr.x).max() <= 1e-10 * np.abs(jr.x).max()
        assert np.abs(A @ r.x - b).max() <= 1e-10 * np.abs(b).max()


def test_embedded_diag_u_against_slogdet(monkeypatch):
    """complex64 through the real ring embedding (``SLU_TPU_COMPLEX=
    embed``): x against the JAX package's embedded 3D factor, logdet
    against numpy's ``slogdet``. The JAX package's 3D ``diag_u`` reads
    Im(U_kk) as F(2k+1, 2k) alone (its driver3d.py:425-428), which is
    Im/Re of the pivot: recorded here as its gap, which the port does
    not copy."""
    monkeypatch.setenv("SLU_TPU_COMPLEX", "embed")
    A, b = _system("complex64", k=9)
    jres, jlu = j_gssvx3d(A, b, JGrid3D(2, 2, 2), _opts(J, "complex64"))
    res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), _opts(T, "complex64"),
                        device="cpu")
    assert lu._embed and jlu._embed
    assert lu.pool[0].dtype == torch.float32
    assert np.abs(res.x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
    assert res.berr.max() <= 1e-12
    sign, logabs = np.linalg.slogdet(A.toarray())
    phase, ld = lu.logdet()
    assert abs(ld - logabs) <= 1e-4 * abs(logabs)
    assert abs(phase - sign) <= 1e-3
    du, jdu = lu.diag_u(), np.asarray(jlu.diag_u())
    assert np.abs(du.real - jdu.real).max() <= 1e-4 * np.abs(du).max()
    # the gap: the JAX package's imaginary parts are the port's over the
    # real parts
    assert np.abs(jdu.imag - du.imag / du.real).max() <= \
        1e-4 * np.abs(du.imag / du.real).max()
    assert np.abs(jdu.imag - du.imag).max() > 1e-2 * np.abs(du.imag).max()


def test_my_permc_geometric_nd_adapt_choice_matches_jax():
    """``col_perm=MY_PERMC`` on a ``geometric_nd`` ordering, with
    ``adapt_pad_max=1`` so that the plan's pad triggers ``_adapt_plan``:
    the single-device drivers of both packages try the same candidates
    and replace the user's order by the same one; the 3D drivers of both
    keep the user's order (their ``_adapt_ok`` is False) in the same
    aligned plan, with x and the DIST counters against the JAX
    package's."""
    k = 6
    A = laplacian_3d(k).tocsc()
    b = np.asarray(A @ np.random.default_rng(4).standard_normal(A.shape[0]))
    order = geometric_nd((k, k, k))
    assert np.array_equal(order, j_nd((k, k, k)))

    def opts(pkg):
        return _opts(pkg, col_perm=pkg.ColPerm.MY_PERMC, user_colperm=order,
                     adapt_pad_max=1.0)

    def adapt(stat):
        return {k: v for k, v in stat.counters.items()
                if k.startswith("adapt_") and k != "adapt_check_s"}

    one, jone = T.SparseLU(A, opts(T), device="cpu"), J.SparseLU(A, opts(J))
    assert adapt(one.stat) == adapt(jone.stat)
    assert one.stat.counters["adapt_chosen"] != "current"
    assert np.array_equal(one.colperm, jone.colperm)
    assert one.plan.nslots == jone.plan.nslots
    jres, jlu = j_gssvx3d(A, b, JGrid3D(2, 2, 2), opts(J))
    res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), opts(T), device="cpu")
    assert lu._expand is not None and jlu._expand is not None
    assert not adapt(res.stat) and not adapt(jres.stat)
    assert np.array_equal(lu.colperm, jlu.colperm)
    assert lu.plan.nslots == jlu.plan.nslots
    assert np.abs(res.x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
    assert _counters(res.stat, 2) == _counters(jres.stat, 2)


@pytest.mark.parametrize("mode", MODES)
def test_profile_levels_counts_match_jax(mode):
    """``profile_levels``: one row per level of the combined schedule,
    labelled "layer" or "top", its steps and Schur products counted as
    the JAX package counts them (a top step once); the profiled factors
    stay live."""
    A, b = _system("float32")
    jlu = JDist3D(A, JGrid3D(2, 2, 2), _opts(J, anc25d=mode))
    lu = T.Distributed3DSparseLU(A, T.Grid3D(2, 2, 2),
                                 _opts(T, anc25d=mode), device="cpu")
    rows, jrows = lu.profile_levels(), jlu.profile_levels()
    assert [(r["level"], r["phase"], r["steps"], r["gemms"]) for r in rows] \
        == [(r["level"], r["phase"], r["steps"], r["gemms"]) for r in jrows]
    assert sum(r["steps"] for r in rows) == lu.plan.nb
    x, berr = lu.refine(b, lu.solve(b))
    assert berr.max() <= 1e-12


def test_reuse_modes_and_save_load(tmp_path):
    """SamePattern_SameRowPerm keeps the plan and the tapes, SamePattern
    reorders; both refine to scipy's x; ``save_factors`` writes the
    single-device checkpoint, which loads and solves."""
    A, b = _system("float64")
    res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), _opts(T, "float64"),
                        device="cpu")
    plan, ft = lu.plan, lu._ft
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.05 * np.random.default_rng(3)
                         .standard_normal(A2.nnz))
    lu.refactor(A2, T.Fact.SAME_PATTERN_SAME_ROWPERM)
    assert lu.plan is plan and lu._ft is ft
    x, berr = lu.refine(b, lu.solve(b))
    ref = spla.spsolve(A2, b)
    assert berr.max() <= 1e-12
    assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()
    lu.refactor(A, T.Fact.SAME_PATTERN)
    x, berr = lu.refine(b, lu.solve(b))
    assert np.abs(x - res.x).max() <= 1e-12 * np.abs(res.x).max()
    path = tmp_path / "dist3d.npz"
    T.save_factors(lu, path)
    one = T.load_factors(path, device="cpu")
    assert type(one) is T.SparseLU
    x, berr = one.refine(b, one.solve(b))
    assert berr.max() <= 1e-12
    assert np.abs(x - res.x).max() <= 1e-12 * np.abs(res.x).max()


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_one_layer_is_bit_equal_to_the_2d_grid(dtype):
    """Grid3D(1, Pr, Pc) runs the 2D grid's jobs: its factors and its x
    bit-equal to ``gssvx_dist`` on Grid2D(Pr, Pc)."""
    A, b = _system(dtype)
    r3, l3 = T.gssvx3d(A, b, T.Grid3D(1, 2, 2), _opts(T, dtype),
                       device="cpu")
    r2, l2 = T.gssvx_dist(A, b, T.Grid2D(2, 2), _opts(T, dtype),
                          device="cpu")
    assert np.array_equal(r3.x, r2.x)
    assert all(torch.equal(p, q) for p, q in zip(l3.pool, l2.pool))
    assert all(torch.equal(p, q) for p, q in zip(l3.linv, l2.linv))


@pytest.mark.parametrize("what,item", [("dist_planning", "10"),
                                       ("several_cards", "8d")])
def test_not_ported_raises_naming_its_item(what, item):
    """Item 8d still raises naming its item. Item 10 is ported: in one
    process ``dist_planning`` runs the ordinary plan, as the JAX package's
    does, so that case holds x to the JAX package's."""
    A, b = _system("float32", k=6)
    if what == "dist_planning":
        res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2),
                            _opts(T, dist_planning=True), device="cpu")
        jres, jlu = j_gssvx3d(A, b, JGrid3D(2, 2, 2),
                              _opts(J, dist_planning=True))
        assert np.array_equal(lu.colperm, jlu.colperm)
        assert np.array_equal(lu.dplan.step_layer, jlu.dplan.step_layer)
        assert np.abs(res.x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md, queue 1 items? {item}"):
        T.Grid3D(2, 1, 2, devices=["cpu", "meta", "cpu", "cpu"])


def test_refuses_what_it_does_not_take():
    A, b = _system("float32", k=6)
    with pytest.raises(ValueError, match="anc25d"):
        T.gssvx3d(A, b, T.Grid3D(2, 1, 1), _opts(T, anc25d="both"),
                  device="cpu")
    with pytest.raises(TypeError, match="Grid3D"):
        T.Distributed3DSparseLU(A, T.Grid2D(2, 2), _opts(T), device="cpu")
    with pytest.raises(TypeError, match="Grid2D"):
        T.gssvx_dist(A, b, T.Grid3D(2, 2, 2), _opts(T), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.gssvx3d(A, b, T.Grid3D(2, 2, 2), _opts(T))
