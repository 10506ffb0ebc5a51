"""The plain versions of the port's RDMA factor and solve
(``superlu_dist_tpu_torch.parallel.dist2d_rdma``) against the JAX
package's XLA 2D executors (``dist2d.build_dist_factor_fn`` and
``build_dist_solve_fn``, about 3 s a case on the 8-device test mesh;
``tests/test_rdma.py`` holds the JAX package's RDMA kernels equal to them
to roundoff, and runs those kernels in interpret mode only under
``slow``, at ~55 s a case).

Tolerances: the factor's per-rank pool, linv and uinv within
1e-4·max(1, max|JAX pool|) in float32 and complex64: the two executors
sum in other orders (blocked XLA products, batched torch products), along
chains of a few dozen products and through the tile inverses; within
1e-12·max(1, max|JAX pool|) in float64 and complex128 (the same orders
of summation, ~4,500 float64 ulp). The solves within 1e-5 relative in
float32 and 1e-12 in float64 and complex128, over the same factors."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import superlu_dist_tpu as J
from superlu_dist_tpu.models.dist_driver import DistributedSparseLU as JDist
from superlu_dist_tpu.ops.host.symbolic import block_symbolic as j_symbolic
from superlu_dist_tpu.parallel import dist2d as jd
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.utils.testing import random_sparse
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.parallel import dist2d as td
from superlu_dist_tpu_torch.parallel import dist2d_rdma as tr
from superlu_dist_tpu_torch.utils.testing import laplacian_2d
from torch_state import numpy_state


def _tiny_diag(A, rows, v=1e-6):
    A = A.tolil()
    for i in rows:
        A[i, i] = v
    return A.tocsc()


BS = 16
TOL = 1e-4
MATRICES = {
    "lap2d12": lambda: laplacian_2d(12).tocsc(),
    "random_unsym": lambda: random_sparse(150, density=0.04, seed=7).tocsc(),
    # three diagonal entries of 1e-6 and no row matching: the factor
    # replaces a tiny pivot
    "tiny_pivots": lambda: _tiny_diag(laplacian_2d(12), (0, 37, 90)),
}
CASES = [("lap2d12", 2, 2), ("lap2d12", 1, 4), ("lap2d12", 4, 2),
         ("lap2d12", 2, 4), ("random_unsym", 2, 2), ("tiny_pivots", 2, 4)]


def _complex(A, seed=5):
    """A with seeded imaginary parts on every entry."""
    A = sp.csc_matrix(A, dtype=np.complex128)
    A.data = A.data + 0.5j * np.random.default_rng(seed).standard_normal(
        A.nnz)
    return A


MATRICES.update({
    "random_cplx": lambda: _complex(random_sparse(150, density=0.04,
                                                  seed=7)),
    # tiny pivots below float64's threshold (sqrt(eps)·max|A|); complex
    # ones keep their phase
    "tiny_pivots64": lambda: _tiny_diag(laplacian_2d(12), (0, 37, 90),
                                        1e-12),
    "tiny_cplx": lambda: _tiny_diag(_complex(laplacian_2d(12)),
                                    (0, 37, 90), 1e-12 * (1 + 1j)),
})
#: (matrix, grid, dtype) of the factor in the other element types
TYPED_CASES = [("lap2d12", 2, 2, "float64"),
               ("tiny_pivots64", 2, 4, "float64"),
               ("random_cplx", 2, 2, "complex64"),
               ("random_cplx", 2, 4, "complex128"),
               ("tiny_cplx", 2, 2, "complex128")]
TYPE_TOL = {"float32": 1e-4, "complex64": 1e-4, "float64": 1e-12,
            "complex128": 1e-12}


@pytest.fixture(scope="module")
def factors():
    """Per case: the port's plain factor state and the JAX XLA executor's
    (pools, linvL, uinvL, tiny), from one plan of A."""
    out = {}

    def get(name, pr, pc, dtype="float32"):
        key = (name, pr, pc, dtype)
        if key not in out:
            A = MATRICES[name]()
            plan, jplan = block_symbolic(A, BS), j_symbolic(A, BS)
            dt = np.dtype(dtype)
            rt = np.finfo(dt).dtype
            thresh = float(rt.type(np.sqrt(np.finfo(dt).eps)
                                   * np.abs(A.data).max()))
            dp = td.partition_plan(plan, pr, pc)
            ft = tr.build_factor_tapes(plan, dp, "cpu")
            st = tr.rdma_factor_plain(
                td.init_local_pools(plan, dp, A.data, dt, "cpu"), thresh,
                ft)
            jdp = jd.partition_plan(jplan, pr, pc)
            grid = JGrid2D(pr, pc)
            fn = jd.build_dist_factor_fn(jplan, jdp, grid)
            jout = fn(jd.init_local_pools(jplan, jdp, A, dt, grid),
                      jnp.asarray(thresh, rt),
                      jd.make_dist_factor_tapes(jdp))
            out[key] = (plan, dp, ft, st,
                        [np.asarray(a) for a in jout[:3]], int(jout[3]))
        return out[key]

    return get


def _ranks(ts, pr, pc):
    return np.stack([t.numpy() for t in ts]).reshape(
        (pr, pc) + tuple(ts[0].shape))


@pytest.mark.parametrize(
    "name,pr,pc,dtype", [c + ("float32",) for c in CASES] + TYPED_CASES,
    ids=[f"{n}-{r}-{c}" for n, r, c in CASES]
    + [f"{n}-{r}-{c}-{d}" for n, r, c, d in TYPED_CASES])
def test_factor_plain_matches_jax_xla(factors, name, pr, pc, dtype):
    """rdma_diag_plain, rdma_panel_plain and rdma_schur_plain over a whole
    factor against the JAX package's XLA grid executor, per rank, in each
    element type (a complex tiny pivot keeps its phase)."""
    plan, dp, ft, st, (jpool, jlinv, juinv), jtiny = factors(name, pr, pc,
                                                             dtype)
    assert st.pool[0].dtype == getattr(torch, dtype)
    assert jpool.dtype == np.dtype(dtype)
    tol = TYPE_TOL[dtype] * max(1.0, float(np.abs(jpool).max()))
    # local slot 1 is the trash block, which the XLA executor's masked
    # lanes write and the port's unpadded jobs never touch
    pool = _ranks(st.pool, pr, pc)
    assert float(np.abs(pool[:, :, 2:] - jpool[:, :, 2:]).max()) <= tol
    assert not pool[:, :, :2].any()
    for got, ref in ((st.linv, jlinv), (st.uinv, juinv)):
        assert float(np.abs(_ranks(got, pr, pc) - ref).max()) <= tol
    assert sum(int(t.item()) for t in st.tiny) == jtiny
    if name.startswith("tiny"):
        assert jtiny > 0


@pytest.mark.parametrize("name,pr,pc", CASES)
def test_receive_counts_equal_recv_tapes(factors, name, pr, pc):
    """The factor's counters, and the sweeps' after a solve on chunks of
    at most two products, equal the TPU's receive tapes."""
    plan, dp, ft, st, _, _ = factors(name, pr, pc)
    got = tr.stacked_recv(st.recv, pr, pc, tr.FACTOR_RECV)
    for k in tr.FACTOR_RECV:
        assert np.array_equal(got[k], ft.recv[k]), k
    # every put of the factor was tallied by its receiver
    assert sum(int(v.sum()) for v in got.values()) == sum(
        int(v.sum()) for v in tr.build_rdma_recv_tapes(plan, dp).values())
    lt, ut = (tr.build_sweep_tapes(plan, dp, w, "cpu", chunk=2)
              for w in "LU")
    B = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (plan.nb, plan.bs, 2)).astype(np.float32))
    _, rl, ru = tr.rdma_solve_plain(st.pool, st.linv, st.uinv, lt, ut, B)
    for recv, tp in ((rl, lt), (ru, ut)):
        counts = tr.stacked_recv(recv, pr, pc, tr.SOLVE_RECV)
        for k in tr.SOLVE_RECV:
            assert np.array_equal(counts[k], tp.recv[k]), (tp.which, k)


@pytest.mark.parametrize("chunk", [None, 1, 3])
@pytest.mark.parametrize("name,pr,pc", CASES)
def test_sweep_chunks_cover_each_chain_once(name, pr, pc, chunk):
    """Each (rank, position) chain of a sweep is cut into chunks that
    cover its products exactly once, in tape order, on its rank; a job's
    chunks take consecutive scratch rows below ``maxq``, distinct within
    a (level, rank), and lie in their level's chunk range."""
    A = MATRICES[name]()
    plan = block_symbolic(A, BS)
    dp = td.partition_plan(plan, pr, pc)
    for which in "LU":
        tp = tr.build_sweep_tapes(plan, dp, which, "cpu", chunk=chunk)
        h = tp.host
        nq = len(h["q_rank"])
        assert tp.qptr[0] == 0 and tp.qptr[-1] == nq == h["chunkptr"][-1]
        seen = set()
        for lvl in range(tp.nlvl):
            for j in range(tp.pptr[lvl, 0], tp.pptr[lvl, -1]):
                q0, q1 = h["chunkptr"][j], h["chunkptr"][j + 1]
                assert tp.qptr[lvl] <= q0 <= q1 <= tp.qptr[lvl + 1]
                prods = [p for q in range(q0, q1)
                         for p in range(h["q_cptr"][q], h["q_cptr"][q + 1])]
                assert prods == list(range(h["cptr"][j], h["cptr"][j + 1]))
                if chunk:
                    assert all(h["q_cptr"][q + 1] - h["q_cptr"][q] <= chunk
                               for q in range(q0, q1))
                assert (h["q_rank"][q0:q1] == h["p_rank"][j]).all()
                rows = h["q_row"][q0:q1]
                assert (np.diff(rows) == 1).all() and (rows < tp.maxq).all()
                for r in rows:
                    key = (lvl, int(h["p_rank"][j]), int(r))
                    assert key not in seen
                    seen.add(key)
        assert len(seen) == nq
        if chunk == 1:
            assert nq == len(h["c_loc"])


@pytest.mark.parametrize("name,pr,pc", CASES)
def test_unwritten_inverse_rows_are_zero(factors, name, pr, pc):
    """Rows of a rank's linvL/uinvL past its own diagonal steps are never
    written and stay zero (the solve reads them, as on the TPU)."""
    plan, dp, ft, st, _, _ = factors(name, pr, pc)
    owned = np.asarray(dp.dptr).reshape(pr * pc, -1)[:, -1]
    for d in range(pr * pc):
        for t in (st.linv[d], st.uinv[d]):
            assert not t[owned[d]:].any()
            assert torch.isfinite(t).all()


@pytest.fixture(scope="module", params=[
    (2, 2, "float32"), (2, 4, "float32"), (2, 2, "float64"),
    (2, 4, "complex128"), (2, 2, "complex64")],
    ids=lambda g: f"{g[0]}x{g[1]}" + ("" if g[2] == "float32"
                                      else f"-{g[2]}"))
def jax_factored(request):
    """A JAX-package DistributedSparseLU (its XLA grid executor outside
    float32) and the port's from its numpy state."""
    pr, pc, dtype = request.param
    A = random_sparse(150, density=0.04, seed=7)
    if dtype.startswith("complex"):
        A = _complex(A)
    opts = dict(dtype=dtype, block_size=BS)
    jlu = JDist(A, JGrid2D(pr, pc), J.Options(**opts))
    state = numpy_state(jlu, T.Options(**opts))
    state.update(pool=np.asarray(jlu.pool), linv=np.asarray(jlu.linv),
                 uinv=np.asarray(jlu.uinv))
    plu = T.DistributedSparseLU.from_numpy_state(state, T.Grid2D(pr, pc),
                                                 device="cpu")
    return jlu, plu


def _rhs(plan, nrhs, dtype):
    rng = np.random.default_rng(nrhs)
    B = rng.standard_normal((plan.n_pad, nrhs))
    if np.dtype(dtype).kind == "c":
        B = B + 1j * rng.standard_normal((plan.n_pad, nrhs))
    return B.astype(dtype)


def _solve_tol(dtype):
    return 1e-5 if dtype in (np.float32, np.complex64) else 1e-12


@pytest.mark.parametrize("nrhs", [1, 3])
def test_solve_plain_matches_jax_xla(jax_factored, nrhs):
    jlu, plu = jax_factored
    plan = plu.plan
    assert plu.dplan.n_local == jlu.dplan.n_local
    assert plu.pool[0].dtype == getattr(torch, plu.options.dtype)
    B = _rhs(plan, nrhs, plu.dtype)
    ref = np.asarray(jlu._solve_fn(nrhs)(jlu.pool, jlu.linv, jlu.uinv,
                                         jlu.stapes, jnp.asarray(B)))
    pr, pc = plu.grid.shape
    # the driver's chunking, then chunks of at most two products, which
    # cut the chains of several products into several chunks
    lt2, ut2 = (tr.build_sweep_tapes(plan, plu.dplan, w, "cpu", chunk=2)
                for w in "LU")
    assert (np.diff(lt2.host["chunkptr"]) > 1).any()
    for lt, ut in ((plu._lt, plu._ut), (lt2, ut2)):
        X, rl, ru = tr.rdma_solve_plain(
            plu.pool, plu.linv, plu.uinv, lt, ut,
            torch.as_tensor(B).view(plan.nb, plan.bs, nrhs))
        got = X.reshape(plan.n_pad, nrhs).numpy()
        assert np.abs(got - ref).max() <= _solve_tol(plu.dtype) * \
            np.abs(ref).max()
        for recv, tp in ((rl, lt), (ru, ut)):
            counts = tr.stacked_recv(recv, pr, pc, tr.SOLVE_RECV)
            for k in tr.SOLVE_RECV:
                assert np.array_equal(counts[k], tp.recv[k]), (tp.which, k)


@pytest.mark.parametrize("nrhs", [1, 3])
def test_trans_solve_plain_matches_jax_xla(jax_factored, nrhs):
    """The transposed sweeps (Uᵀ with uinv, then Lᵀ with linv; partials
    gathered down the grid columns) against the JAX package's
    ``build_dist_trans_solve_fn`` on the same factors, on the driver's
    chunks and on chunks of at most two products; their receive counts
    equal their tapes', and a row's partials arrive from Pr − 1 peers."""
    jlu, plu = jax_factored
    plan = plu.plan
    B = _rhs(plan, nrhs, plu.dtype)
    ref = np.asarray(jlu._trans_solve_fn(nrhs)(
        jlu.pool, jlu.uinv, jlu.linv, None, None, B))
    pr, pc = plu.grid.shape
    for chunk in (None, 2):
        lt, ut = (tr.build_sweep_tapes(plan, plu.dplan, w, "cpu",
                                       chunk=chunk) for w in ("LT", "UT"))
        assert lt.transpose and ut.transpose and lt.npeer == pr
        X, rl, ru = tr.rdma_solve_plain(
            plu.pool, plu.linv, plu.uinv, lt, ut,
            torch.as_tensor(B).view(plan.nb, plan.bs, nrhs))
        got = X.reshape(plan.n_pad, nrhs).numpy()
        assert np.abs(got - ref).max() <= _solve_tol(plu.dtype) * \
            np.abs(ref).max()
        for recv, tp in ((rl, lt), (ru, ut)):
            counts = tr.stacked_recv(recv, pr, pc, tr.SOLVE_RECV)
            for k in tr.SOLVE_RECV:
                assert np.array_equal(counts[k], tp.recv[k]), (tp.which, k)
            solved = np.bincount(
                tp.host["d_rank"], minlength=pr * pc).reshape(pr, pc)
            assert (tp.recv["rcv_part"].sum(axis=2)
                    == (pr - 1) * solved).all()


def test_from_numpy_state_checks_the_partition(jax_factored):
    jlu, plu = jax_factored
    state = numpy_state(jlu, T.Options(dtype=plu.options.dtype,
                                       block_size=BS))
    state.update(pool=np.asarray(jlu.pool)[:, :, :-1],
                 linv=np.asarray(jlu.linv), uinv=np.asarray(jlu.uinv))
    with pytest.raises(ValueError, match="partition"):
        T.DistributedSparseLU.from_numpy_state(state, plu.grid,
                                               device="cpu")
