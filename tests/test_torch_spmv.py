"""Refinement's SpMV: the port's four products (``ops/spmv.py``) and the
grid's ``dist_spmv`` against the JAX package's ``ops/kernels/spmv.py`` on
the same matrix, in float64 to 1e-14 relative (other summation orders of
the same entries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from superlu_dist_tpu.ops.kernels import spmv as jspmv

from superlu_dist_tpu_torch.ops import spmv
from superlu_dist_tpu_torch.parallel import dist2d as td
from superlu_dist_tpu_torch.utils import testing as tt

REL = 1e-14


def _dense_row_empty_rows(n=120, seed=5):
    """A random pattern with one full row and a few rows without
    entries."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.04, random_state=rng, format="lil")
    A[17, :] = rng.standard_normal(n)
    for r in (3, 40, 99):
        A[r, :] = 0
    A = sp.csc_matrix(A)
    A.eliminate_zeros()
    return A


MATRICES = {"unsym": lambda: tt.unsymmetric_pattern(200, seed=1),
            "dense_row": _dense_row_empty_rows}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def matrix(request):
    return MATRICES[request.param]()


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", ["spmv", "abs_spmv", "spmv_t",
                                  "abs_spmv_t"])
def test_spmv_matches_jax(matrix, name, nrhs):
    A = matrix
    n = A.shape[0]
    x = np.random.default_rng(nrhs).standard_normal((n, nrhs))
    got = getattr(spmv, name)(spmv.coo_arrays(A, np.float64, "cpu"),
                              torch.as_tensor(x)).numpy()
    rows, cols, vals = jspmv.coo_arrays(A, jnp.float64)
    ref = getattr(jspmv, name)(rows, cols, vals, jnp.asarray(x), n)
    _close(got, ref)


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_dist_spmv_matches_jax(matrix, ndev, nrhs):
    A = matrix
    n = A.shape[0]
    x = np.random.default_rng(nrhs).standard_normal((n, nrhs))
    rows, cols, vals = jspmv.coo_arrays(A, jnp.float64)
    for absolute, fn in ((False, jspmv.spmv), (True, jspmv.abs_spmv)):
        got = td.dist_spmv(td.coo_shards(A, ndev, np.float64, "cpu"),
                           torch.as_tensor(x), n, absolute=absolute)
        _close(got.numpy(), fn(rows, cols, vals, jnp.asarray(x), n))


def test_empty_rows_are_zero_and_buckets_cover_each_entry_once():
    """Rows without entries sum to exact zeros; every entry is in one
    bucket row of its output row; padding stays under twice the entries
    on a matrix with hub rows."""
    for A in (_dense_row_empty_rows(), tt.circuit_graph(3000, seed=2)):
        coo = spmv.coo_arrays(A, np.float64, "cpu")
        for seg, ss in ((coo.rows, coo.by_row), (coo.cols, coo.by_col)):
            seen = np.zeros(ss.nnz, dtype=np.int64)
            padded = 0
            for out, idx in ss.buckets:
                idx = idx.numpy()
                padded += idx.size
                for r, row in zip(out.numpy(), idx):
                    e = row[row < ss.nnz]
                    assert np.all(seg.numpy()[e] == r)
                    seen[e] += 1
            assert np.all(seen == 1)
            assert padded < 2 * ss.nnz
    A = _dense_row_empty_rows()
    y = spmv.spmv(spmv.coo_arrays(A, np.float64, "cpu"),
                  torch.ones(A.shape[0], 2, dtype=torch.float64))
    assert torch.equal(y[[3, 40, 99]], torch.zeros(3, 2, dtype=y.dtype))
