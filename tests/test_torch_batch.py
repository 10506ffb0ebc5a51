"""The port's batched interface (``BatchedSparseLU``, ``gssvx_batch``) on
the CPU, where the level executor's kernels with a member axis run their
plain versions, against the JAX package's ``models/batch.py`` (its
``jax.vmap`` of the XLA level core, and its block-diagonal composite on
one device and on the 8-device test mesh).

Tolerances: the float32 pools within ``test_torch_schur.py``'s rule (128
float32 ulp of the pool's scale plus twice the JAX float32 factor's own
error against the float64 truth, per block); X after refinement within
1e-8 of the JAX package's X and of the true x (``tests/test_batch.py``'s
limit); float64 and complex128 batches within 1e-10 of the JAX package's
X and berr <= 1e-12; the batched plain versions bit-equal to the
unbatched ones member by member."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.models.batch import BatchedSparseLU as JBatch
from superlu_dist_tpu.models.batch import gssvx_batch as j_gssvx_batch
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.utils.testing import random_sparse
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.kernels import diag_lu, schur, solve_gemm
from superlu_dist_tpu_torch.utils.testing import helmholtz_3d, laplacian_2d
from test_torch_schur import assert_f32_close_to_truth

torch.set_num_threads(2)


def _members(count=4, seed=0, complex_=False):
    """``tests/test_batch.py``'s batch: laplacian_2d(7) with every entry
    times (1 + 0.1·N(0, 1)) per member, from one generator (complex: a
    seeded imaginary part too), and right-hand sides of known x."""
    base = laplacian_2d(7)
    rng = np.random.default_rng(seed)
    As = []
    for _ in range(count):
        A = base.copy().astype(np.complex128 if complex_ else np.float64)
        A.data = A.data * (1.0 + 0.1 * rng.standard_normal(A.nnz))
        if complex_:
            A.data = A.data + 0.3j * rng.standard_normal(A.nnz)
        As.append(sp.csc_matrix(A))
    n = base.shape[0]
    Xt = rng.standard_normal((count, n))
    if complex_:
        Xt = Xt + 1j * rng.standard_normal((count, n))
    Bs = np.stack([As[i] @ Xt[i] for i in range(count)])
    return As, Bs, Xt


def test_same_pattern_batch_matches_jax():
    """float32, bs 16: the per-member scalings equal the JAX package's,
    each member's factored pool within the float32 rule of JAX's
    ``pool_b``, and X after ``refine`` within 1e-8 of JAX's X and of the
    true x."""
    As, Bs, Xt = _members()
    o = dict(dtype="float32", block_size=16)
    tb = T.BatchedSparseLU(As, T.Options(**o), device="cpu")
    jb = JBatch(As, J.Options(**o))
    assert tb.plan.nslots == jb.plan.nslots
    # the prototype carries the plan and tapes and holds no factor of its
    # own: the batch factors every member, the first included
    assert tb._proto.pool is None and tb._proto._ftapes is not None
    assert np.array_equal(tb.row_scales, jb.row_scales)
    assert np.array_equal(tb.col_scales, jb.col_scales)
    ns = tb.plan.nslots
    jpool = np.asarray(jb.pool_b)[:, :ns]
    for m in range(len(As)):
        # the float64 truth: the right-looking reference on the member's
        # pool in float64
        p = tb._proto
        A3 = As[m].multiply(tb.row_scales[m][:, None]).multiply(
            tb.col_scales[m][None, :]).tocsc()
        A3 = p._expand_A(sp.csc_matrix(A3[p.rowperm, :][p.colperm, :]
                                       [:, p.colperm]))
        truth = blocklu.factor_plain(
            tb.plan, blocklu.init_pool(tb.plan, A3.data, np.float64, "cpu"),
            float(tb._proto._thresh()))[0].numpy()
        ref_err = np.abs(jpool[m] - truth[:ns]).max(axis=(1, 2))
        assert_f32_close_to_truth(tb.pool_b[m].numpy(), jpool[m], ns,
                                  2 * ref_err, ulps=128)
    X, berr = tb.refine(Bs, tb.solve(Bs))
    Xj, berrj = jb.refine(Bs, jb.solve(Bs))
    assert X.shape == Xt.shape
    assert np.abs(X - Xj).max() < 1e-8
    assert np.abs(X - Xt).max() < 1e-8
    assert berr.max() <= 1e-12
    assert "FACT" in tb.stat.utime
    assert tb.refine_steps.max() == tb.stat.refine_steps


def test_same_pattern_batch_rejects_mismatch():
    A1 = laplacian_2d(5)
    A2 = random_sparse(25, density=0.2, seed=1)
    with pytest.raises(ValueError, match="identical sparsity"):
        T.BatchedSparseLU([A1, A2], T.Options(dtype="float32", block_size=8),
                          device="cpu")


def test_batched_per_matrix_scalings():
    """``tests/test_advice_fixes.py::test_batched_per_matrix_scalings``:
    one pattern, wildly different row scales; each member keeps its own
    equilibration, as in the JAX package."""
    A0 = laplacian_2d(7)
    n = A0.shape[0]
    rng = np.random.default_rng(0)
    s = 10.0 ** rng.uniform(-6, 6, size=n)
    A1 = sp.csc_matrix(A0.multiply(s[:, None]))
    o = dict(dtype="float32", block_size=16)
    blu = T.BatchedSparseLU([A0, A1], T.Options(**o), device="cpu")
    jb = JBatch([A0, A1], J.Options(**o))
    assert not np.allclose(blu.row_scales[0], blu.row_scales[1])
    assert np.array_equal(blu.row_scales, jb.row_scales)
    xt = rng.standard_normal((2, n))
    B = np.stack([np.asarray(A0 @ xt[0]), np.asarray(A1 @ xt[1])])
    X, berr = blu.refine(B, blu.solve(B))
    assert berr.max() < 1e-11
    assert np.abs(X - xt).max() < 1e-5 * np.abs(xt).max()


@pytest.mark.parametrize("dtype", ["float64", "complex64", "complex128"])
def test_typed_batches_match_jax(dtype):
    """float64, complex64 and complex128 batches (several right-hand
    sides) against the JAX package's: X within 1e-10, berr <= 1e-12, the
    pools within 1e-10 (1e-4 in complex64) of scale."""
    cplx = dtype.startswith("complex")
    As, Bs, Xt = _members(3, seed=4, complex_=cplx)
    Bs = np.stack([Bs, 2 * Bs], axis=2)
    o = dict(dtype=dtype, block_size=16)
    tb = T.BatchedSparseLU(As, T.Options(**o), device="cpu")
    jb = JBatch(As, J.Options(**o))
    assert tb.pool_b.dtype == getattr(torch, dtype)
    ns = tb.plan.nslots
    jpool = np.asarray(jb.pool_b)[:, :ns]
    tol = 1e-4 if dtype == "complex64" else 1e-10
    assert np.abs(tb.pool_b[:, :ns].numpy() - jpool).max() <= tol * max(
        1.0, np.abs(jpool).max())
    X, berr = tb.refine(Bs, tb.solve(Bs))
    Xj, _ = jb.refine(Bs, jb.solve(Bs))
    assert X.shape == Bs.shape
    assert berr.max() <= 1e-12
    assert np.abs(X - Xj).max() <= 1e-10 * np.abs(Xj).max()
    assert np.abs(X[:, :, 0] - Xt).max() <= 1e-10 * np.abs(Xt).max()


@pytest.mark.parametrize("dtype", list(diag_lu.CUDA_DTYPES),
                         ids=lambda d: str(d)[6:])
def test_batched_plain_versions_are_unbatched_per_member(dtype):
    """On the CPU the batched plain versions (``factor_batch``,
    ``solve_batch``) are bit-equal to the unbatched ones applied member by
    member, tiny counts included (a member with a tiny pivot among
    them)."""
    name = str(dtype)[6:]
    A = helmholtz_3d(4).tocsc() if dtype.is_complex \
        else laplacian_2d(9).tocsc()
    lu = T.SparseLU(A, T.Options(dtype=name, block_size=16,
                                 executor="pallas"), device="cpu")
    plan, tp = lu.plan, lu._ftapes
    pools = []
    for m in range(3):
        v = lu._a3_data * (1 + 0.1 * np.random.default_rng(m)
                           .standard_normal(len(lu._a3_data)))
        if m == 2:
            v[0] = 0.0           # a tiny pivot in the first diagonal block
        pools.append(blocklu.init_pool(plan, v, lu.dtype, "cpu"))
    P = torch.stack(pools)
    th = [1e-3, 2e-3, 3e-3]
    Pb, Lb, Ub, tb = schur.factor_batch(
        P.clone(), torch.tensor(th, dtype=P.real.dtype), tp, plan.nb)
    X = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (3, plan.nb, plan.bs, 2)), dtype=dtype)
    Xb = solve_gemm.solve_batch(Pb, Lb, Ub, lu._ltape, lu._utape, X.clone())
    assert int(tb[2]) >= 1
    for m in range(3):
        th_m = float(torch.tensor(th[m], dtype=P.real.dtype))
        p1, l1, u1, t1 = schur.factor(P[m].clone(), th_m, tp, plan.nb)
        assert torch.equal(Pb[m], p1) and torch.equal(Lb[m], l1)
        assert torch.equal(Ub[m], u1) and int(tb[m]) == int(t1.item())
        x1 = solve_gemm.solve(p1, l1, u1, lu._ltape, lu._utape, X[m].clone())
        assert torch.equal(Xb[m], x1)


def _heterogeneous(complex_=False):
    """``tests/test_batch.py``'s composite batch: a Laplacian and two
    random matrices (one complex with ``complex_``)."""
    rng = np.random.default_rng(2)
    As = [laplacian_2d(5),
          random_sparse(40, density=0.1, seed=3, diag_dominant=False),
          random_sparse(33, density=0.15, seed=4)]
    if complex_:
        A = sp.csc_matrix(As[2], dtype=np.complex128)
        A.data = A.data + 0.5j * rng.standard_normal(A.nnz)
        As[2] = A
    xs = [rng.standard_normal(A.shape[0]) for A in As]
    Bs = [np.asarray(A @ x) for A, x in zip(As, xs)]
    return As, Bs, xs


@pytest.mark.parametrize("grid", [None, (2, 4)], ids=["device", "2x4"])
def test_gssvx_batch_matches_jax(grid):
    """The block-diagonal composite against the JAX package's, on one
    device (``SparseLU``) and on a 2×4 grid (``DistributedSparseLU``;
    the JAX package's on the 8-device mesh): each x within 1e-10 of
    JAX's, berr <= 1e-12, the same refinement steps within one."""
    As, Bs, xs = _heterogeneous()
    o = dict(dtype="float32", block_size=16)
    res, lu = T.gssvx_batch(As, Bs, T.Options(**o), device="cpu",
                            grid=None if grid is None else T.Grid2D(*grid))
    jres, jlu = j_gssvx_batch(As, Bs, J.Options(**o),
                              grid=None if grid is None else JGrid2D(*grid))
    want = T.SparseLU if grid is None else T.DistributedSparseLU
    assert type(lu) is want
    assert len(res) == 3
    for r, j, xt in zip(res, jres, xs):
        assert r.berr.max() <= 1e-12
        assert np.abs(r.x - j.x).max() <= 1e-10 * np.abs(j.x).max()
        assert np.abs(r.x - xt).max() < 1e-6 * max(1, np.abs(xt).max())
        assert abs(r.stat.refine_steps - j.stat.refine_steps) <= 1


def test_gssvx_batch_complex_member():
    """A batch with one complex member is solved in complex128 (the JAX
    package's batch.py:226): every x is complex, against JAX's."""
    As, Bs, xs = _heterogeneous(complex_=True)
    o = dict(dtype="complex128", block_size=16)
    res, _ = T.gssvx_batch(As, Bs, T.Options(**o), device="cpu")
    jres, _ = j_gssvx_batch(As, Bs, J.Options(**o))
    for r, j in zip(res, jres):
        assert r.x.dtype == np.complex128
        assert r.berr.max() <= 1e-12
        assert np.abs(r.x - j.x).max() <= 1e-10 * np.abs(j.x).max()


def test_gssvx_batch_grid3d_raises():
    """A 3D grid whose ranks sit on several devices names its ROADMAP item
    (8d, the port's only refusal of a 3D grid here; on one device the
    composite runs on ``Distributed3DSparseLU``,
    tests/test_torch_dist3d.py)."""
    As, Bs, _ = _heterogeneous()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, queue 1 item 8d"):
        T.gssvx_batch(As, Bs, T.Options(dtype="float32", block_size=16),
                      grid=T.Grid3D(2, 1, 1, devices=["cpu", "meta"]),
                      device="cpu")


def test_package_surface_matches_jax():
    """The top-level names of the JAX package's ``__init__``:
    ``__version__``, ``get_version_number``, ``set_default_options``,
    ``sp_ienv``, ``print_options``, and the batch's two."""
    assert T.__version__ == J.__version__
    assert T.get_version_number() == J.get_version_number()
    assert T.set_default_options() == T.Options()
    assert T.sp_ienv("BLOCK_SIZE") == J.sp_ienv("BLOCK_SIZE")
    assert T.print_options(T.Options()) == J.print_options(J.Options())
    for name in ("BatchedSparseLU", "gssvx_batch", "__version__",
                 "get_version_number", "set_default_options", "sp_ienv",
                 "print_options"):
        assert name in T.__all__
