"""Row-distributed input in the port: ``NRLocMatrix`` (the
``NRformat_loc`` analog, a copy of the JAX package's), the single-device
driver's gather of its chunks, and the owner mapping of sharded NRLoc
input (the dReDistribute_A analog) in 2D and 3D, against the JAX package.

Tolerances: the pools from NRLoc chunks within 1e-6 of the JAX package's
(its test_nrloc_sharded.py) and bit-equal to the port's own pools of the
global permuted matrix; ``gssvx`` on chunks bit-equal to ``gssvx`` on the
matrix in the port and x within 1e-10 relative of the JAX package's."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.parallel import dist2d as jd2
from superlu_dist_tpu.parallel import dist3d as jd3
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.parallel.grid import Grid3D as JGrid3D
from superlu_dist_tpu.utils.nrloc import NRLocMatrix as JNRLoc
from superlu_dist_tpu.utils.testing import random_sparse
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.parallel import dist2d as td2
from superlu_dist_tpu_torch.parallel import dist3d as td3
from superlu_dist_tpu_torch.parallel.window import Window
from superlu_dist_tpu_torch.utils.nrloc import NRLocMatrix
from superlu_dist_tpu_torch.utils.testing import laplacian_2d


def test_nrloc_matches_jax():
    A = laplacian_2d(6)
    n = A.shape[0]
    for parts in (1, 3, 4):
        loc, jloc = NRLocMatrix.from_global(A, parts), \
            JNRLoc.from_global(A, parts)
        assert not loc.local and [f for f, _ in loc.chunks] == \
            [f for f, _ in jloc.chunks]
        for (_, M), (_, jM) in zip(loc.chunks, jloc.chunks):
            assert (M != jM).nnz == 0
        assert (loc.to_global() != jloc.to_global()).nnz == 0
        assert (loc.to_global() != A).nnz == 0
        for dt in (None, np.float32):
            for a, b in zip(loc.to_coo_arrays(dt), jloc.to_coo_arrays(dt)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        x = np.arange(n, dtype=float)
        got, ref = loc.scatter_solution(x), jloc.scatter_solution(x)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        assert np.array_equal(loc.gather_rhs(got), jloc.gather_rhs(ref))
    rows = sp.csr_matrix(A)[:10]
    part, jpart = NRLocMatrix([(0, rows)], n, local=True), \
        JNRLoc([(0, rows)], n, local=True)
    assert part.local
    assert (part.to_partial_csc() != jpart.to_partial_csc()).nnz == 0
    assert part.to_partial_csc().nnz == rows.nnz
    for bad in (lambda M: M([(0, rows)], n, local=True).to_global(),
                lambda M: M([(0, rows)], n),           # a gap
                lambda M: M([(0, sp.csr_matrix((3, n + 1)))], n),
                lambda M: M.from_global(A, 2).gather_rhs([np.ones(3)])):
        for M in (NRLocMatrix, JNRLoc):
            with pytest.raises(ValueError):
                bad(M)


def test_gssvx_gathers_nrloc_chunks():
    A = random_sparse(120, density=0.05, seed=3, diag_dominant=True)
    b = np.asarray(A @ np.random.default_rng(1).standard_normal(120))
    opts = dict(dtype="float32", block_size=16)
    res, _ = T.gssvx(NRLocMatrix.from_global(A, 3), b, T.Options(**opts),
                     device="cpu")
    one, _ = T.gssvx(A, b, T.Options(**opts), device="cpu")
    jres, _ = J.gssvx(JNRLoc.from_global(A, 3), b, J.Options(**opts))
    assert np.array_equal(res.x, one.x)
    assert np.abs(res.x - jres.x).max() <= 1e-10 * np.abs(jres.x).max()
    # one process cannot hold a share of the rows
    with pytest.raises(ValueError, match="multi-process"):
        T.DistributedSparseLU(
            NRLocMatrix([(0, sp.csr_matrix(A)[:60])], 120, local=True),
            T.Grid2D(2, 2), T.Options(**opts), device="cpu")


def _case(with_mc64):
    """A matrix, the port's and the JAX package's SparseLU of it (their
    preprocessing, on one aligned plan) and its A3 in the port."""
    A = random_sparse(96, density=0.08, seed=5, diag_dominant=True)
    kw = dict(dtype="float32", block_size=16, align_blocks="on")
    perm = "LARGE_DIAG_MC64" if with_mc64 else "NOROWPERM"
    lu = T.SparseLU(A, T.Options(row_perm=T.RowPerm[perm], **kw),
                    device="cpu")
    jlu = J.SparseLU(A, J.Options(row_perm=J.RowPerm[perm], **kw))
    assert (lu.row_scale != 1).any() == with_mc64     # MC64 scales
    A3 = A.multiply(lu.row_scale[:, None]) \
          .multiply(lu.col_scale[None, :]).tocsc()
    A3 = A3[lu.rowperm, :][lu.colperm, :][:, lu.colperm]
    return A, lu, jlu, lu._expand_A(sp.csc_matrix(A3))


def _args(lu, chunks, n):
    return (chunks, lu.row_scale, lu.col_scale, lu.rowperm, lu.colperm,
            lu._expand, lu._n_e, n)


@pytest.mark.parametrize("with_mc64", [False, True])
def test_nrloc_offsets_match_gathered_pool(with_mc64):
    """The per-entry (rank, offset, value) mapping and the scatter into
    the owners' pools reproduce the pools of the global permuted
    matrix."""
    A, lu, jlu, A3 = _case(with_mc64)
    n, plan = A.shape[0], lu.plan
    dplan = td2.partition_plan(plan, 2, 4)
    ref = td2.init_local_pools(plan, dplan, A3.data, np.float32, "cpu")
    dev, off, val = td2.nrloc_entry_offsets(
        plan, dplan, *_args(lu, NRLocMatrix.from_global(A, 3).chunks, n),
        with_identity=True)
    got = td2.init_local_pools_nrloc(plan, dplan, Window(8, "cpu"), dev,
                                     off, val, np.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    jdplan = jd2.partition_plan(jlu.plan, 2, 4)
    jdev, joff, jval = jd2.nrloc_entry_offsets(
        jlu.plan, jdplan, *_args(jlu, JNRLoc.from_global(A, 3).chunks, n),
        with_identity=True)
    assert np.array_equal(dev, jdev) and np.array_equal(off, joff)
    jgot = np.asarray(jd2.init_local_pools_nrloc(
        jlu.plan, jdplan, JGrid2D(2, 4), jdev, joff, jval, np.float32))
    got = np.stack([p.numpy() for p in got]).reshape(jgot.shape)
    assert np.abs(got - jgot).max() < 1e-6


def test_nrloc_offsets_match_gathered_pool_3d():
    """The 3D owner mapping (ancestors on their layer-0 replica) and the
    scatter reproduce the 3D grid's pools of the global matrix."""
    A, lu, jlu, A3 = _case(False)
    n, plan = A.shape[0], lu.plan
    dplan = td3.partition_plan3d(plan, 2, 2, 2)
    ref = td3.init_local_pools3d(plan, dplan, A3.data, np.float32, "cpu")
    dev, off, val = td3.nrloc_entry_offsets3d(
        plan, dplan, *_args(lu, NRLocMatrix.from_global(A, 3).chunks, n),
        with_identity=True)
    got = td3.init_local_pools3d_nrloc(plan, dplan, Window(8, "cpu"), dev,
                                       off, val, np.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    jdplan = jd3.partition_plan3d(jlu.plan, 2, 2, 2)
    jdev, joff, jval = jd3.nrloc_entry_offsets3d(
        jlu.plan, jdplan, *_args(jlu, JNRLoc.from_global(A, 3).chunks, n),
        with_identity=True)
    assert np.array_equal(dev, jdev) and np.array_equal(off, joff)
    jgot = np.asarray(jd3.init_local_pools3d_nrloc(
        jlu.plan, jdplan, JGrid3D(2, 2, 2), jdev, joff, jval, np.float32))
    got = np.stack([p.numpy() for p in got]).reshape(jgot.shape)
    assert np.abs(got - jgot).max() < 1e-6
