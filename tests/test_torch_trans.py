"""The port's transposed solves, TRANS refinement, condition estimate,
``logdet``, reuse modes and factor persistence on the CPU (plain versions
of the kernels) against the JAX package on the same matrices and Options,
and against dense or scipy truths."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.models import driver as jdrv
from superlu_dist_tpu.utils.testing import random_sparse

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.utils import testing as tt
from superlu_dist_tpu_torch.utils.norms import langs

from torch_state import numpy_state

torch.set_num_threads(2)


def _rand(n=90, seed=11, density=0.08):
    """tests/test_trans_cond.py's matrix: random values, a random
    (not dominant) diagonal, so |z| of the condition estimate has no ties
    and the Hager iteration takes the same steps in both packages."""
    return random_sparse(n, density=density, seed=seed, diag_dominant=False)


def _lu_pair(A, **kw):
    jlu = J.SparseLU(A, J.Options(**kw))
    tlu = T.SparseLU(A, T.Options(**kw), device="cpu")
    return jlu, tlu


@pytest.fixture(scope="module")
def f64_pair():
    A = _rand()
    return (A,) + _lu_pair(A, dtype="float64", block_size=16)


@pytest.mark.parametrize("code", [T.Trans.TRANS, T.Trans.CONJ, "T", 1, "C",
                                  2], ids=["TRANS", "CONJ", "T", "1", "C",
                                           "2"])
def test_solve_trans_codes(f64_pair, code):
    """Every code of a transposed solve, one and three right-hand sides:
    the JAX package's x to 1e-12 relative (both float64 factors of the
    same plan, other summation orders; measured ~1e-15) and Aᵀx = b."""
    A, jlu, tlu = f64_pair
    rng = np.random.default_rng(1)
    jcode = code if not isinstance(code, T.Trans) else J.Trans(code.value)
    for b in (rng.standard_normal(A.shape[0]),
              rng.standard_normal((A.shape[0], 3))):
        x = tlu.solve(b, trans=code)
        xj = np.asarray(jlu.solve(b, trans=jcode))
        assert x.shape == b.shape
        assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()
        assert np.abs(A.T @ x - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("code", ["X", 3, -1, True, None, 1.0])
def test_invalid_trans_raises(f64_pair, code):
    _, _, tlu = f64_pair
    with pytest.raises(ValueError, match="invalid trans"):
        tlu.solve(np.ones(tlu.n), trans=code)


def test_solve_transposed_tensor_in_tensor_out(f64_pair):
    A, _, tlu = f64_pair
    b = torch.arange(A.shape[0], dtype=torch.float64)
    x = tlu.solve_transposed(b)
    assert isinstance(x, torch.Tensor) and x.shape == b.shape
    assert np.abs(A.T @ x.numpy() - b.numpy()).max() < 1e-9


TRANS_CASES = {
    "rand90": (lambda: _rand(), 16),
    "unsym": (lambda: tt.unsymmetric_pattern(200, seed=1), 16),
    "kkt": (lambda: tt.kkt_system(200, seed=2), 16),
    "lap3d8u": (lambda: tt.laplacian_3d_unsym(8, seed=1), 32),
}


@pytest.mark.parametrize("trans", ["TRANS", "CONJ"])
@pytest.mark.parametrize("name", sorted(TRANS_CASES))
def test_gssvx_trans_matches_jax(name, trans):
    """gssvx with ``options.trans``: both refine an f32 factor with f64
    residuals in Aᵀ; the solutions agree to 1e-10 relative (measured
    ~1e-15), berr ≤ 1e-15 and the host loop's stopping rule gives the
    same refinement steps."""
    make, bs = TRANS_CASES[name]
    A = make().tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rj, _ = J.gssvx(A, b, J.Options(dtype="float32", block_size=bs,
                                    trans=J.Trans[trans]))
    rt, _ = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                    trans=T.Trans[trans]), device="cpu")
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    assert rt.berr.max() < 1e-15 and rj.berr.max() < 1e-15
    assert rt.stat.refine_steps == rj.stat.refine_steps
    assert np.abs(A.T @ rt.x - b).max() / np.abs(b).max() < 1e-12


def test_gssvx_trans_norefine_berr():
    """Without refinement, berr is the Aᵀ backward error of the f32
    solve, as the JAX package computes it."""
    A = _rand().tocsc()
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    kw = dict(dtype="float32", block_size=16)
    rj, _ = J.gssvx(A, b, J.Options(trans=J.Trans.TRANS,
                                    iter_refine=J.IterRefine.NOREFINE, **kw))
    rt, _ = T.gssvx(A, b, T.Options(trans=T.Trans.TRANS,
                                    iter_refine=T.IterRefine.NOREFINE, **kw),
                    device="cpu")
    assert rt.stat.refine_steps == 0
    # f32 solves of one plan in other summation orders: the same order of
    # backward error (measured 2.3e-7 and 2.4e-7)
    assert 0.2 < rt.berr.max() / rj.berr.max() < 5
    assert rt.berr.max() < 1e-5


def _dense_rcond(A):
    return 1.0 / (langs("1", A)
                  * np.abs(np.linalg.inv(A.toarray())).sum(axis=0).max())


def test_rcond_matches_jax_and_dense(f64_pair):
    """Float64 factors: the JAX value to 1e-10 relative (the same Hager
    steps on solutions that agree to ~1e-15), and the dense truth within
    the 30x bound of tests/test_trans_cond.py."""
    A, jlu, tlu = f64_pair
    est, ref = tlu.rcond_1(), jlu.rcond_1()
    assert abs(est - ref) <= 1e-10 * ref
    truth = _dense_rcond(A)
    assert truth / 30 < est < truth * 30
    for k in ("rcond_iters", "rcond_converged"):
        assert tlu.stat.counters[k] == jlu.stat.counters[k]


def test_rcond_ill_conditioned_tight():
    """tests/test_trans_cond.py's graded case (cond ~ 1e8): within 10% of
    the dense 1-norm value."""
    n = 120
    A = sp.diags(np.logspace(0, -8, n)).tocsc() + 1e-10 * sp.csc_matrix(
        random_sparse(n, density=0.05, seed=13, diag_dominant=False))
    lu = T.SparseLU(A, T.Options(dtype="float64", block_size=16),
                    device="cpu")
    est = lu.rcond_1()
    truth = _dense_rcond(A)
    assert 0.9 * truth < est < 1.1 * truth, (est, truth)
    assert lu.stat.counters["rcond_iters"] >= 1
    assert lu.stat.counters["rcond_converged"] in (0, 1)


def test_condition_number_option_matches_jax():
    """gssvx with ``condition_number``: rcond of the f32 factors within
    1e-3 relative of the JAX package's (the estimate of a matrix with
    cond ~1e4 carries the f32 solves' error, measured 3e-4), and an RCOND
    phase."""
    A = _rand()
    b = np.asarray(A @ np.ones(A.shape[0]))
    kw = dict(dtype="float32", block_size=16, condition_number=True)
    rj, _ = J.gssvx(A, b, J.Options(**kw))
    rt, _ = T.gssvx(A, b, T.Options(**kw), device="cpu")
    assert rt.rcond is not None and 0 < rt.rcond < 1
    assert abs(rt.rcond - rj.rcond) <= 1e-3 * rj.rcond
    assert "RCOND" in rt.stat.utime
    assert rt.stat.counters["rcond_iters"] == rj.stat.counters["rcond_iters"]


def test_logdet_matches_jax_and_slogdet(f64_pair):
    A, jlu, tlu = f64_pair
    sign, logabs = tlu.logdet()
    js, jl = jlu.logdet()
    ds, dl = np.linalg.slogdet(A.toarray())
    # the JAX package multiplies unit complex phases (-0.99999999999999856
    # here); the port's real signs multiply exactly
    assert sign == ds and abs(js - sign) < 1e-12
    # float64 factors: log|det| to 1e-12 relative of the dense value
    assert abs(logabs - jl) <= 1e-12 * abs(jl)
    assert abs(logabs - dl) <= 1e-10 * abs(dl)


def test_logdet_with_row_permutation_and_alignment():
    """MC64 moves rows (odd and even parities both occur over seeds) and
    the etree alignment expands the plan: the sign still matches."""
    for seed in range(3):
        A = tt.unsymmetric_pattern(150, seed=seed).tocsc()
        lu = T.SparseLU(A, T.Options(dtype="float64", block_size=16),
                        device="cpu")
        sign, logabs = lu.logdet()
        ds, dl = np.linalg.slogdet(A.toarray())
        assert sign == ds
        assert abs(logabs - dl) <= 1e-10 * abs(dl)


def _check(A, b, res, trans=False):
    op = A.T if trans else A
    assert res.berr.max() < 1e-15
    assert np.abs(op @ res.x - b).max() / np.abs(b).max() < 1e-12


def test_reuse_chain_matches_jax():
    """DOFACT → SamePattern → SamePattern_SameRowPerm → FACTORED (the
    pddrive1/2/3 staging of tests/test_driver.py), NOTRANS and TRANS, in
    both packages: the same x to 1e-10, and the phases each mode runs."""
    A = tt.unsymmetric_pattern(200, seed=1).tocsc()
    rng = np.random.default_rng(9)
    A2 = A.copy()
    A2.data = A.data * (1.0 + 0.05 * rng.standard_normal(A.nnz))
    A3 = A2.copy()
    A3.data = A2.data * (1.0 + 0.05 * rng.standard_normal(A2.nnz))
    kw = dict(dtype="float32", block_size=16)
    steps = [(A, "DOFACT"), (A2, "SAME_PATTERN"),
             (A3, "SAME_PATTERN_SAME_ROWPERM"), (A3, "FACTORED")]
    jlu = tlu = None
    for i, (M, fact) in enumerate(steps):
        trans = i % 2 == 1
        b = np.random.default_rng(i).standard_normal(M.shape[0])
        tr = "TRANS" if trans else "NOTRANS"
        rj, jlu = J.gssvx(M, b, J.Options(fact=J.Fact[fact],
                                          trans=J.Trans[tr], **kw), lu=jlu)
        plan0 = tlu.plan if tlu is not None else None
        rt, tlu = T.gssvx(M, b, T.Options(fact=T.Fact[fact],
                                          trans=T.Trans[tr], **kw), lu=tlu,
                          device="cpu")
        _check(M, b, rt, trans)
        assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
        ph = set(rt.stat.utime)
        if fact == "SAME_PATTERN_SAME_ROWPERM":
            assert not ph & {"EQUIL", "ROWPERM", "COLPERM"}
            assert tlu.plan is plan0 and "FACT" in ph
        elif fact == "SAME_PATTERN":
            assert {"EQUIL", "ROWPERM", "COLPERM", "FACT"} <= ph
        elif fact == "FACTORED":
            assert "FACT" not in ph and "SYMBFAC" not in ph


def test_reuse_mode_errors():
    A = tt.laplacian_2d(6).tocsc()
    b = np.ones(A.shape[0])
    with pytest.raises(ValueError, match="FACTORED requires"):
        T.gssvx(A, b, T.Options(block_size=8, fact=T.Fact.FACTORED),
                device="cpu")
    with pytest.raises(ValueError, match="FACTORED requires"):
        T.SparseLU(A, T.Options(block_size=8, fact=T.Fact.FACTORED),
                   device="cpu")
    with pytest.raises(ValueError, match="no prior factorization"):
        T.SparseLU(A, T.Options(block_size=8, fact=T.Fact.SAME_PATTERN),
                   device="cpu")
    lu = T.SparseLU(A, T.Options(block_size=8), device="cpu")
    with pytest.raises(ValueError, match="SamePattern"):
        lu.refactor(A, T.Fact.DOFACT)


def test_trans_valid_after_rowperm_changing_refactor():
    """The stale-tape trap (tests/test_trans_cond.py:160): a SamePattern
    refactor that changes MC64's row permutation must drop the cached
    transposed tapes; the transposed solve then matches scipy."""
    rng = np.random.default_rng(5)
    A = random_sparse(96, density=0.08, seed=8, diag_dominant=False)
    n = A.shape[0]
    lu = T.SparseLU(A, T.Options(dtype="float64", block_size=16,
                                 row_perm=T.RowPerm.LARGE_DIAG_MC64),
                    device="cpu")
    b = rng.standard_normal(n)
    lu.solve_transposed(b)              # builds and caches the tapes
    perm0, plan0 = lu.rowperm.copy(), lu.plan
    A2 = A.copy()
    A2.data = A2.data * (1.0 + 0.8 * np.abs(rng.standard_normal(A.nnz)))
    lu.refactor(A2, fact=T.Fact.SAME_PATTERN)
    assert not np.array_equal(lu.rowperm, perm0) and lu.plan is not plan0
    ref = spla.spsolve(sp.csc_matrix(A2.T), b)
    x = lu.solve_transposed(b)
    assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "port_to_port"])
def test_save_load_round_trips(tmp_path, direction):
    """A checkpoint written by either package loads in the other and
    solves (NOTRANS and TRANS, refined) to the same x as the writer; the
    port writes the JAX package's bucket-padded shapes, so JAX's clamped
    gathers never see an out-of-range index."""
    A = tt.unsymmetric_pattern(200, seed=1).tocsc()
    kw = dict(dtype="float32", block_size=16)
    p = tmp_path / "factors.npz"
    if direction == "jax_to_port":
        writer = J.SparseLU(A, J.Options(**kw))
        jdrv.save_factors(writer, p)
        reader = T.load_factors(p, device="cpu")
    else:
        writer = T.SparseLU(A, T.Options(**kw), device="cpu")
        T.save_factors(writer, p)
        reader = (jdrv.load_factors(p) if direction == "port_to_jax"
                  else T.load_factors(p, device="cpu"))
        z = np.load(p)
        ref = J.SparseLU(A, J.Options(**kw))
        assert z["pool"].shape == np.asarray(ref.pool).shape
        assert z["linv"].shape == np.asarray(ref.linv).shape
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.shape[0])
    for trans in ("NOTRANS", "TRANS"):
        xs = []
        for lu in (writer, reader):
            tr = (J.Trans if isinstance(lu, J.SparseLU) else T.Trans)[trans]
            x, berr = lu.refine(b, lu.solve(b, trans=tr), trans=tr)
            assert berr.max() < 1e-14
            xs.append(np.asarray(x))
        assert np.abs(xs[0] - xs[1]).max() <= 1e-10 * np.abs(xs[0]).max()
        op = A.T if trans == "TRANS" else A
        assert np.abs(op @ xs[1] - b).max() < 1e-10 * np.abs(b).max()


def test_loaded_factors_serve_rcond_and_logdet(tmp_path):
    A = _rand()
    kw = dict(dtype="float64", block_size=16)
    lu = T.SparseLU(A, T.Options(**kw), device="cpu")
    p = tmp_path / "f.npz"
    T.save_factors(lu, p)
    lu2 = T.load_factors(p, device="cpu")
    assert lu2.rcond_1() == pytest.approx(lu.rcond_1(), rel=1e-12)
    assert lu2.logdet() == pytest.approx(lu.logdet(), rel=1e-12)


def test_carried_jax_factors_serve_trans_rcond_logdet(f64_pair):
    """A JAX-package factorization carried in through ``from_numpy_state``
    (bucket-padded arrays cut on the way in): the same factors give the
    transposed solve, rcond and logdet of the JAX package to 1e-12."""
    A, jlu, _ = f64_pair
    tlu = T.SparseLU.from_numpy_state(numpy_state(jlu, T.Options(
        dtype="float64", block_size=16)), device="cpu")
    b = np.random.default_rng(8).standard_normal(A.shape[0])
    xj = np.asarray(jlu.solve_transposed(b))
    assert np.abs(tlu.solve_transposed(b) - xj).max() \
        <= 1e-12 * np.abs(xj).max()
    assert tlu.rcond_1() == pytest.approx(jlu.rcond_1(), rel=1e-12)
    (s, l), (js, jl) = tlu.logdet(), jlu.logdet()
    assert s == pytest.approx(js, abs=1e-12)
    assert l == pytest.approx(jl, rel=1e-12)


def test_load_factors_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    A = tt.laplacian_2d(6).tocsc()
    lu = T.SparseLU(A, T.Options(block_size=8), device="cpu")
    p = tmp_path / "f.npz"
    T.save_factors(lu, p)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.load_factors(p)
