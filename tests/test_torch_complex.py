"""complex64 and complex128 through the port on the CPU (the plain
versions of the level executor's kernels) against the JAX package's native
complex CPU path: the plain kernels against dense numpy, the host
preprocessing and plan, the whole factor, the NOTRANS, TRANS and CONJ
solves with refinement, ``rcond_1``, ``logdet``, ``profile_levels``,
ILU(1), the reuse modes, ``from_numpy_state`` from the JAX package's
native and planar states, and checkpoints both ways. Inputs come from
numpy seeds; both packages see the same arrays."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.utils.testing import random_sparse

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.kernels import diag_lu, schur, solve_gemm
from superlu_dist_tpu_torch.ops.kernels import sweep
from superlu_dist_tpu_torch.utils import testing as tt

from torch_state import numpy_state

torch.set_num_threads(2)

DTYPES = ("complex64", "complex128")
#: the whole pool against the JAX package's, relative to max(1, |ref|):
#: both eliminate in their working type in other orders
POOL_TOL = {"complex64": 1e-4, "complex128": 1e-10}


def _random_complex(n=120, seed=3, density=0.06):
    """``tests/test_planar.py``'s 120×120 random complex matrix."""
    rng = np.random.default_rng(seed)
    A = sp.csc_matrix(random_sparse(n, density=density, seed=seed)
                      .astype(np.complex128))
    A.data = A.data + 1j * rng.standard_normal(A.nnz)
    return A


MATS = {"helm6": (lambda: tt.helmholtz_3d(6).tocsc(), 16),
        "rand120": (_random_complex, 32)}
_CACHE = {}


def _rhs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _pair(mat, dtype):
    """(A, port SparseLU on the CPU, JAX SparseLU) of one matrix and dtype,
    made once per test process."""
    key = (mat, dtype)
    if key not in _CACHE:
        make, bs = MATS[mat]
        A = make()
        lt = T.SparseLU(A, T.Options(dtype=dtype, block_size=bs),
                        device="cpu")
        lj = J.SparseLU(A, J.Options(dtype=dtype, block_size=bs))
        _CACHE[key] = (A, lt, lj)
    return _CACHE[key]


def _dense_blocks(plan, pool):
    """The pool's blocks placed at their (row, column) in a dense matrix
    of the plan's padded order."""
    bs = plan.bs
    M = np.zeros((plan.nb * bs, plan.nb * bs), dtype=np.complex128)
    P = pool.numpy()
    for s in range(plan.nslots):
        r, c = int(plan.slot_row[s]), int(plan.slot_col[s])
        M[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = P[s]
    return M


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_kernels_match_dense(dtype):
    """The level executor's plain phases (lu_inv_plain, trsm_plain with
    both flags, schur_plain) factor helm6's pool into L·U = A3 (dense
    numpy, no tiny pivots) and agree with the right-looking
    ``factor_plain``; the plain sweeps (solve_level_plain, both flags)
    solve L·U x = b and (L·U)ᵀ y = b against dense numpy."""
    A, lt, _ = _pair("helm6", dtype)
    plan, tp = lt.plan, lt._ftapes
    th = lt._thresh()
    pool0 = blocklu.init_pool(plan, lt._a3_data, lt.dtype, "cpu")
    pool = pool0.clone()
    nb, bs = plan.nb, plan.bs
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32)
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        lp = slice(int(tp.lptr[lvl]), int(tp.lptr[lvl + 1]))
        up = slice(int(tp.uptr[lvl]), int(tp.uptr[lvl + 1]))
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[d].long(),
                              tp.dstep[d].long(), th, tiny)
        schur.trsm_plain(pool, uinv, tp.lslot[lp], tp.lstep[lp], False)
        schur.trsm_plain(pool, linv, tp.uslot[up], tp.ustep[up], True)
        schur.schur_plain(pool, tp, lvl)
    assert int(tiny) == 0
    eps = np.finfo(lt.dtype).eps
    ref, rli, rui, rt = blocklu.factor_plain(plan, pool0.clone(), th)
    assert rt == 0
    for got, want in ((pool, ref), (linv, rli), (uinv, rui)):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 64 * eps * scale
    M0 = _dense_blocks(plan, pool0)
    M = _dense_blocks(plan, pool)
    L = np.tril(M, -1) + np.eye(len(M))
    U = np.triu(M)
    err = np.abs(L @ U - M0).max()
    assert err <= 1e3 * eps * np.abs(M0).max()
    b = _rhs(nb * bs, 1)
    for transpose in (False, True):
        X = torch.tensor(b.reshape(nb, bs, 1), dtype=pool.dtype)
        if transpose:
            tu, tl = (solve_gemm.build_trans_tape(plan, w, "cpu")
                      for w in "UL")
            sweeps, op = ((tu, uinv), (tl, linv)), (L @ U).T
        else:
            sweeps, op = ((lt._ltape, linv), (lt._utape, uinv)), L @ U
        for tape, dinv in sweeps:
            for lvl in range(tape.nlvl):
                solve_gemm.solve_level_plain(pool, dinv, X, tape, lvl,
                                             transpose)
        x = X.reshape(-1).numpy()
        assert np.abs(op @ x - b).max() <= 1e4 * eps * np.abs(b).max()
    # the NOTRANS plain sweep of kernel 3 is the same function
    Xa = torch.tensor(b.reshape(nb, bs, 1), dtype=pool.dtype)
    Xb = Xa.clone()
    for tape, dinv in ((lt._ltape, linv), (lt._utape, uinv)):
        for lvl in range(tape.nlvl):
            sweep.sweep_level_plain(pool, dinv, Xa, tape, lvl)
            solve_gemm.solve_level_plain(pool, dinv, Xb, tape, lvl, False)
    assert torch.equal(Xa, Xb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_pivot_keeps_phase(dtype):
    """lu_inv_plain replaces a complex pivot below the threshold by
    (p/|p|)·thresh (+thresh at 0) and counts it, as the JAX package's
    ``blocklu._replace_tiny``; its L and U reproduce the modified tile."""
    bs, thresh = 16, 1e-3
    rng = np.random.default_rng(5)
    M = (rng.standard_normal((bs, bs)) + 1j * rng.standard_normal((bs, bs))
         + bs * np.eye(bs))
    piv = {3: 1e-9 * (1 - 1j), 7: -2e-9j, 11: 0.0}
    for j, v in piv.items():
        M[j, :j] = 0
        M[:j, j] = 0
        M[j, j] = v
    Tt = torch.as_tensor(M[None]).to(getattr(torch, dtype))
    LU, li, ui, nt = diag_lu.lu_inv_plain(Tt, thresh)
    assert int(nt) == 3
    eps = np.finfo(np.dtype(dtype)).eps
    for j, v in piv.items():
        want = thresh * (v / abs(v) if v else 1.0)
        assert abs(complex(LU[0, j, j]) - want) <= 4 * eps * thresh
    Mm = M.copy()
    for j, v in piv.items():
        Mm[j, j] = thresh * (v / abs(v) if v else 1.0)
    lu = LU[0].numpy().astype(np.complex128)
    L = np.tril(lu, -1) + np.eye(bs)
    U = np.triu(lu)
    assert np.abs(L @ U - Mm).max() <= 1e3 * eps * np.abs(Mm).max()
    # the inverses carry the tile's conditioning: entries near 1/thresh
    I, Li, Ui = np.eye(bs), li[0].numpy(), ui[0].numpy()
    assert np.abs(Li @ L - I).max() <= \
        bs * eps * np.abs(Li).max() * np.abs(L).max()
    assert np.abs(U @ Ui - I).max() <= \
        bs * eps * np.abs(Ui).max() * np.abs(U).max()


def test_host_preprocessing_matches_jax():
    """Equilibration, MC64, the column order and the block plan of a
    complex matrix equal the JAX package's: row and column scales,
    permutations and every plan field."""
    A, lt, lj = _pair("rand120", "complex128")
    np.testing.assert_allclose(lt.row_scale, np.asarray(lj.row_scale),
                               rtol=1e-14)
    np.testing.assert_allclose(lt.col_scale, np.asarray(lj.col_scale),
                               rtol=1e-14)
    assert np.array_equal(lt.rowperm, np.asarray(lj.rowperm))
    assert np.array_equal(lt.colperm, np.asarray(lj.colperm))
    for f in dataclasses.fields(lt.plan):
        a, b = getattr(lt.plan, f.name), getattr(lj.plan, f.name)
        if isinstance(a, (int, float, np.integer, np.floating)):
            assert a == b, f.name
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mat", sorted(MATS))
def test_factor_matches_jax(mat, dtype):
    """The whole pool and both inverse tables after the factor against the
    JAX package's native complex factor (``_export_factors``), with equal
    tiny-pivot counts; the port's factor runs the level executor in the
    working dtype."""
    A, lt, lj = _pair(mat, dtype)
    assert lt.stat.counters["executor"] == "pallas"
    assert lt.pool.dtype == getattr(torch, dtype)
    assert lt.stat.tiny_pivots == lj.stat.tiny_pivots
    pool, linv, uinv = lj._export_factors()
    ns, nb = lt.plan.nslots, lt.plan.nb
    for got, want in ((lt.pool[:ns], pool[:ns]), (lt.linv, linv[:nb]),
                      (lt.uinv, uinv[:nb])):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= POOL_TOL[dtype] * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mat", sorted(MATS))
def test_solves_match_jax(mat, dtype, trans):
    """NOTRANS, TRANS and CONJ: refined x against the JAX package's to
    1e-10 relative, berr at most 1e-12 on both, residual in A, Aᵀ or Aᴴ;
    the refinement residual is complex128."""
    A, lt, lj = _pair(mat, dtype)
    b = _rhs(A.shape[0], 2)
    op = {"N": A, "T": A.T, "C": A.conj().T}[trans]
    xt, bt = lt.refine(b, lt.solve(b, trans=trans), trans=trans)
    jt = J.Trans(trans)
    xj, bj = lj.refine(b, lj.solve(b, trans=jt), trans=jt)
    assert lt.refine_dtype == np.complex128
    assert bt.max() <= 1e-12 and bj.max() <= 1e-12
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.abs(op @ xt - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_gssvx_trans_conj_with_rcond(dtype):
    """``gssvx`` with ``trans`` and ``condition_number`` on helm6: x and
    rcond against the JAX package's gssvx."""
    A, _, _ = _pair("helm6", dtype)
    b = _rhs(A.shape[0], 3)
    for trans in ("T", "C"):
        rt, _ = T.gssvx(A, b, T.Options(dtype=dtype, block_size=16,
                                        trans=T.Trans(trans),
                                        condition_number=True),
                        device="cpu")
        rj, _ = J.gssvx(A, b, J.Options(dtype=dtype, block_size=16,
                                        trans=J.Trans(trans),
                                        condition_number=True))
        assert rt.berr.max() <= 1e-12
        assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
        assert rt.rcond == pytest.approx(rj.rcond, rel=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mat", sorted(MATS))
def test_rcond_and_logdet_match_jax(mat, dtype):
    """``rcond_1`` (the JAX package's Hager/Higham steps, np.sign of a
    complex y included) and ``logdet`` (phase and log-modulus) against
    the JAX package's, and logdet against numpy's slogdet."""
    A, lt, lj = _pair(mat, dtype)
    rtol = 1e-4 if dtype == "complex64" else 1e-10
    assert lt.rcond_1() == pytest.approx(lj.rcond_1(), rel=rtol)
    pt, lt_abs = lt.logdet()
    pj, lj_abs = lj.logdet()
    assert isinstance(pt, (complex, np.complexfloating))
    assert abs(pt - pj) <= 10 * rtol and lt_abs == pytest.approx(
        lj_abs, rel=rtol)
    ds, dl = np.linalg.slogdet(A.toarray().astype(np.complex128))
    tol = 1e-4 if dtype == "complex64" else 1e-10
    assert abs(pt - ds) <= tol and abs(lt_abs - dl) <= tol * abs(dl)
    du = lt.diag_u()
    assert du.dtype == np.dtype(dtype) and du.shape == (A.shape[0],)


@pytest.mark.parametrize("dtype", DTYPES)
def test_profile_levels(dtype):
    """``profile_levels`` on a complex factor: its levels equal the JAX
    package's profile of the same plan, and the solve after it equals the
    one before."""
    from superlu_dist_tpu.ops.kernels import blocklu as jbl
    A = tt.helmholtz_3d(5).tocsc()
    lu = T.SparseLU(A, T.Options(dtype=dtype, block_size=8), device="cpu")
    b = _rhs(A.shape[0], 4)
    x0 = lu.solve(b)
    rows = lu.profile_levels()
    jrows, _ = jbl.profile_factor_levels(lu.plan, lu._a3_data,
                                         np.complex128, lu._thresh(),
                                         chunk=16)
    keys = ("level", "steps", "lpanels", "upanels", "gemms")
    assert [{k: r[k] for k in keys} for r in rows] == \
        [{k: r[k] for k in keys} for r in jrows]
    x1 = lu.solve(b)
    assert np.array_equal(x0, x1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ilu1_matches_jax(dtype):
    """ILU(1) on a complex Helmholtz operator: the port's level executor
    on the ILU plan and refinement as a preconditioned Richardson
    iteration, against the JAX package's."""
    A = tt.helmholtz_3d(6).tocsc()
    b = _rhs(A.shape[0], 5)
    kw = dict(dtype=dtype, block_size=16, ilu_level=1, max_refine_steps=60,
              refine_rthresh=1.0)
    rt, lu = T.gssvx(A, b, T.Options(**kw), device="cpu")
    rj, jlu = J.gssvx(A, b, J.Options(**kw))
    assert rt.stat.counters["executor"] == "pallas"
    assert lu.plan.nslots == jlu.plan.nslots
    assert rt.berr.max() <= 1e-12 and rj.berr.max() <= 1e-12
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_reuse_modes_match_jax(dtype):
    """SamePattern_SameRowPerm, SamePattern and FACTORED on perturbed
    complex values, each against the JAX package's same sequence."""
    A = _random_complex()
    b = _rhs(A.shape[0], 6)
    kw = dict(dtype=dtype, block_size=32)
    _, lu = T.gssvx(A, b, T.Options(**kw), device="cpu")
    _, jlu = J.gssvx(A, b, J.Options(**kw))
    rng = np.random.default_rng(7)
    M = A.copy()
    for fact in ("SAME_PATTERN_SAME_ROWPERM", "SAME_PATTERN", "FACTORED"):
        if fact != "FACTORED":
            M = M.copy()
            M.data = M.data * (1 + 0.05 * rng.standard_normal(M.nnz))
        rt, lu = T.gssvx(M, b, T.Options(fact=getattr(T.Fact, fact), **kw),
                         lu=lu)
        rj, jlu = J.gssvx(M, b, J.Options(fact=getattr(J.Fact, fact),
                                          **kw), lu=jlu)
        assert rt.berr.max() <= 1e-12
        assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
        assert np.abs(M @ rt.x - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("layout", ["native", "planar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_from_numpy_state(dtype, layout, monkeypatch):
    """A JAX-package factorization loads through ``from_numpy_state``:
    its native complex pool, and its planar (re, im) pool of
    (slots, 2, bs, bs), which the JAX test process forces with
    ``SLU_TPU_FORCE_PLANAR=1``; both solve and refine as the JAX package
    does."""
    A = _random_complex()
    b = _rhs(A.shape[0], 8)
    kw = dict(dtype=dtype, block_size=32)
    if layout == "planar":
        monkeypatch.setenv("SLU_TPU_FORCE_PLANAR", "1")
    jlu = J.SparseLU(A, J.Options(**kw))
    state = numpy_state(jlu, T.Options(**kw))
    assert state["pool"].ndim == (4 if layout == "planar" else 3)
    tlu = T.SparseLU.from_numpy_state(state, device="cpu")
    assert tlu.pool.dtype == getattr(torch, dtype)
    for trans in ("N", "C"):
        xt, bt = tlu.refine(b, tlu.solve(b, trans=trans), trans=trans)
        jt = J.Trans(trans)
        xj, bj = jlu.refine(b, jlu.solve(b, trans=jt), trans=jt)
        assert bt.max() <= 1e-12
        assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_both_ways(dtype, tmp_path):
    """The port's checkpoint (its native complex pool) loads in the JAX
    package, the JAX package's in the port; each solves to the other's
    x."""
    A, lt, lj = _pair("helm6", dtype)
    b = _rhs(A.shape[0], 9)
    T.save_factors(lt, tmp_path / "t.npz")
    J.save_factors(lj, tmp_path / "j.npz")
    jl = J.load_factors(tmp_path / "t.npz")
    tl = T.load_factors(tmp_path / "j.npz", device="cpu")
    assert np.asarray(jl.pool).dtype == np.dtype(dtype)
    for trans in ("N", "T"):
        jt = J.Trans(trans)
        x1, b1 = jl.refine(b, jl.solve(b, trans=jt), trans=jt)
        x2, b2 = tl.refine(b, tl.solve(b, trans=trans), trans=trans)
        x3, _ = lt.refine(b, lt.solve(b, trans=trans), trans=trans)
        assert b1.max() <= 1e-12 and b2.max() <= 1e-12
        for x in (x1, x2):
            assert np.abs(x - x3).max() <= 1e-10 * np.abs(x3).max()


# ---------------------------------------------------------------------------
# complex64 in the ring embedding a+bi -> [[a, -b], [b, a]]
# ---------------------------------------------------------------------------


@pytest.fixture
def embed_env(monkeypatch):
    """``SLU_TPU_COMPLEX=embed`` for both packages, as
    ``tests/test_embed.py`` sets it (each reads it when it factors)."""
    monkeypatch.setenv("SLU_TPU_COMPLEX", "embed")
    monkeypatch.delenv("SLU_TPU_FORCE_PALLAS", raising=False)


def _embed_fixture(n_grid=8, seed=5):
    """``tests/test_embed.py``'s matrix: laplacian_2d(n_grid) + (2+i)·I
    with seeded imaginary parts (complex64)."""
    rng = np.random.default_rng(seed)
    A = tt.laplacian_2d(n_grid).tocsc().astype(np.complex64)
    A = A + 1j * sp.random(*A.shape, density=0.01,
                           random_state=rng.integers(1 << 30),
                           format="csc").astype(np.complex64)
    A = A + sp.eye(A.shape[0], dtype=np.complex64, format="csc") * (2 + 1j)
    return sp.csc_matrix(A)


EMBED_OPTS = dict(dtype="complex64", block_size=16)
#: the embedded float32 pools against each other: both eliminate the 2n
#: real rows in float32, in other orders
EMBED_POOL_TOL = 1e-4


@pytest.mark.parametrize("executor", [None, "flk", "pallas", "tck"])
def test_embedded_pool_matches_jax(embed_env, executor):
    """The port's embedded factor (float32, 2n rows, every float32
    executor: clk by default, flk, the level executor, tck) against the
    JAX package's embedded pool slot by slot on the same plan."""
    A = _embed_fixture()
    lt = T.SparseLU(A, T.Options(executor=executor, **EMBED_OPTS),
                    device="cpu")
    lj = J.SparseLU(A, J.Options(**EMBED_OPTS))
    assert lt._embed and lj._embed
    assert lt.pool.dtype == torch.float32
    assert lt.plan.n == 2 * lj._n_e or lt._expand is None
    assert lt.executor == (executor or "clk")
    assert lt.plan.nslots == lj.plan.nslots
    assert np.array_equal(lt.colperm, lj.colperm)
    assert np.array_equal(lt._rows_idx, lj._rows_idx)
    ns = lt.plan.nslots
    jp = np.asarray(lj.pool)[:ns]
    assert np.abs(lt.pool[:ns].numpy() - jp).max() <= EMBED_POOL_TOL * max(
        1.0, np.abs(jp).max())


@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_embedded_solves_match_jax(embed_env, trans):
    """NOTRANS, TRANS and CONJ through the embedded factor: x within 1e-4
    relative of the JAX package's embedded solve, then refined (complex128
    residuals against the complex A) to berr <= 1e-12; rcond_1 within
    1e-3 of the JAX package's."""
    A = _embed_fixture()
    n = A.shape[0]
    b = _rhs(n, 11)
    lt = T.SparseLU(A, T.Options(**EMBED_OPTS), device="cpu")
    lj = J.SparseLU(A, J.Options(**EMBED_OPTS))
    xt = lt.solve(b, trans=trans)
    xj = lj.solve(b, trans=J.Trans(trans))
    assert np.abs(xt - xj).max() <= 1e-4 * np.abs(xj).max()
    op = {"N": A, "T": A.T, "C": A.conj().T}[trans]
    x, berr = lt.refine(b, xt, trans=trans)
    assert berr.max() <= 1e-12
    assert np.abs(op @ x - b).max() <= 1e-12 * np.abs(b).max() * n
    assert abs(lt.rcond_1() - lj.rcond_1()) <= 1e-3 * lj.rcond_1()


def test_embedded_gssvx_refines(embed_env):
    """``gssvx`` in the embedding with condition_number, as the JAX
    package's: the same refinement limits, berr <= 1e-12."""
    A = _embed_fixture(9, seed=7)
    b = _rhs(A.shape[0], 12)
    rt, lu = T.gssvx(A, b, T.Options(condition_number=True, **EMBED_OPTS),
                     device="cpu")
    rj, _ = J.gssvx(A, b, J.Options(condition_number=True, **EMBED_OPTS))
    assert lu._embed and rt.berr.max() <= 1e-12
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    assert abs(rt.rcond - rj.rcond) <= 1e-3 * rj.rcond


def test_embedded_logdet_matches_dense(embed_env):
    """``logdet`` of the embedded factor against numpy's dense slogdet:
    phase within 1e-4 and log|det| within 1e-4 relative. The embedded pool
    is the scalar LU of the 2n real matrix, so a diagonal block s = a+bi
    stores the L entry b/a at (2k+1, 2k), and Im(U_kk) is that entry
    times F(2k, 2k). The JAX package reads the entry alone
    (superlu_dist_tpu/models/driver.py:1777-1784) and its phase is off;
    this test records that divergence on purpose."""
    A = _embed_fixture()
    sign, logabs = np.linalg.slogdet(A.toarray().astype(np.complex128))
    lt = T.SparseLU(A, T.Options(**EMBED_OPTS), device="cpu")
    s, la = lt.logdet()
    assert abs(s - sign) <= 1e-4
    assert abs(la - logabs) <= 1e-4 * abs(logabs)
    js, jla = J.SparseLU(A, J.Options(**EMBED_OPTS)).logdet()
    # the JAX package's read: its phase is off, its log|det| off by ~0.18
    # (inside the 1e-2 relative that tests/test_embed.py allows)
    assert abs(js - sign) > 1e-2
    assert abs(jla - logabs) > 1e-2


def test_embedded_diag_u_matches_native(embed_env, monkeypatch):
    """The embedded factor's diag_u against the native complex64 factor's
    on the same plan (rows in the same elimination order), within the
    float32 tolerance."""
    A = _embed_fixture()
    lt = T.SparseLU(A, T.Options(**EMBED_OPTS), device="cpu")
    monkeypatch.delenv("SLU_TPU_COMPLEX")
    ln = T.SparseLU(A, T.Options(**EMBED_OPTS), device="cpu")
    assert lt._embed and not ln._embed
    assert np.array_equal(lt.colperm, ln.colperm)
    de, dn = lt.diag_u(), ln.diag_u()
    assert de.dtype == np.complex64
    assert np.abs(de - dn).max() <= 1e-4 * np.abs(dn).max()


def test_embedded_checkpoints_both_ways(embed_env, tmp_path):
    """A JAX-written embedded checkpoint (``embed`` true, float32 pool of
    2n rows) loads in the port and solves and refines to the JAX
    package's x, with logdet's phase within 1e-4 of dense slogdet; the
    port's embedded checkpoint loads in the JAX package."""
    A = _embed_fixture()
    b = _rhs(A.shape[0], 13)
    lj = J.SparseLU(A, J.Options(**EMBED_OPTS))
    lt = T.SparseLU(A, T.Options(**EMBED_OPTS), device="cpu")
    J.save_factors(lj, tmp_path / "j.npz")
    T.save_factors(lt, tmp_path / "t.npz")
    assert bool(np.load(tmp_path / "t.npz")["embed"])
    tl = T.load_factors(tmp_path / "j.npz", device="cpu")
    jl = J.load_factors(tmp_path / "t.npz")
    assert tl._embed and jl._embed and tl.pool.dtype == torch.float32
    sign = np.linalg.slogdet(A.toarray().astype(np.complex128))[0]
    assert abs(tl.logdet()[0] - sign) <= 1e-4
    for trans in ("N", "C"):
        jt = J.Trans(trans)
        xj, _ = lj.refine(b, lj.solve(b, trans=jt), trans=jt)
        for lu in (tl, lt):
            x, berr = lu.refine(b, lu.solve(b, trans=trans), trans=trans)
            assert berr.max() <= 1e-12
            assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()
        x2 = jl.solve(b, trans=jt)
        assert np.abs(x2 - xj).max() <= 1e-4 * np.abs(xj).max()


def test_embedded_grid_state_loads(embed_env):
    """A JAX-package grid state in the embedding (its per-rank float32
    pools on a 2×2 mesh) through ``DistributedSparseLU.from_numpy_state``
    solves and refines to the JAX grid's x; the port's embedded
    ``gssvx_dist`` on the same grid matches it, with TRANS and CONJ."""
    from superlu_dist_tpu.models.dist_driver import gssvx_dist as j_dist
    from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
    A = _embed_fixture()
    n = A.shape[0]
    b = _rhs(n, 14)
    jres, jlu = j_dist(A, b, JGrid2D(2, 2), J.Options(**EMBED_OPTS))
    assert jlu._embed
    state = numpy_state(jlu, T.Options(**EMBED_OPTS))
    state.update(pool=np.asarray(jlu.pool), linv=np.asarray(jlu.linv),
                 uinv=np.asarray(jlu.uinv))
    assert state["embed"]
    tl = T.DistributedSparseLU.from_numpy_state(state, T.Grid2D(2, 2),
                                                device="cpu")
    assert tl._embed and tl.pool[0].dtype == torch.float32
    x, berr = tl.refine(b, tl.solve(b))
    assert berr.max() <= 1e-12
    assert np.abs(x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
    for trans, op in (("N", A), ("T", A.T), ("C", A.conj().T)):
        res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 2), T.Options(
            trans=T.Trans(trans), **EMBED_OPTS), device="cpu")
        assert lu._embed and res.berr.max() <= 1e-12
        assert np.abs(op @ res.x - b).max() <= 1e-12 * n * np.abs(b).max()
    sign = np.linalg.slogdet(A.toarray().astype(np.complex128))[0]
    assert abs(lu.logdet()[0] - sign) <= 1e-4