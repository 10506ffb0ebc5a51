"""Host preprocessing parity: the port's copy of the host modules builds
the same permutations, scalings, alignment expansion, SymbolicPlan,
level order and initial pool as the JAX package, for the same matrix
and Options (exact equality: the same numpy/C++ code runs on the same
input)."""

import dataclasses

import numpy as np
import pytest
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.ops.kernels import blocklu as jbl

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.utils import testing as tt

torch.set_num_threads(2)

CASES = {
    "lap2d12": lambda: tt.laplacian_2d(12),
    "lap3d8": lambda: tt.laplacian_3d(8),
    "fem3d": lambda: tt.fem3d_delaunay(120, seed=1),
    "circuit": lambda: tt.circuit_graph(500, seed=3),
    "kkt": lambda: tt.kkt_system(300, seed=2),
    "aniso2d": lambda: tt.aniso2d(14),
    "unsym": lambda: tt.unsymmetric_pattern(150, seed=4),
}


def host_plan(mod, A, opts):
    """Run a driver's host pipeline (preprocess, symbolic, adaptive plan)
    without the numeric factor. Returns (lu, A3, plan)."""
    lu = mod.SparseLU.__new__(mod.SparseLU)
    lu.options, lu.stat = opts, mod.Stats()
    lu.n = A.shape[0]
    lu.dtype = np.dtype(np.float32)
    lu.plan = None
    lu._A_orig = A
    if mod is J:
        lu._embed = False
        A3 = lu._preprocess(A, False, False)
    else:
        A3 = lu._preprocess(A)
    lu._anorm = float(np.abs(A3.data).max())
    plan = lu._symbolic(A3)
    A3, plan = lu._adapt_plan(A3, plan)
    return lu, A3, plan


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_host_pipeline_matches(name, bs):
    A = CASES[name]().tocsc()
    jl, jA3, jp = host_plan(J, A, J.Options(dtype="float32", block_size=bs))
    tl, tA3, tp = host_plan(T, A, T.Options(dtype="float32", block_size=bs))
    for attr in ("rowperm", "colperm", "row_scale", "col_scale"):
        np.testing.assert_array_equal(getattr(jl, attr), getattr(tl, attr),
                                      err_msg=attr)
    je, te = getattr(jl, "_expand", None), tl._expand
    assert (je is None) == (te is None)
    if je is not None:
        np.testing.assert_array_equal(je, te)
        assert jl._n_e == tl._n_e
    np.testing.assert_array_equal(jA3.toarray(), tA3.toarray())
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f.name)),
                                      np.asarray(getattr(tp, f.name)),
                                      err_msg=f.name)
    # the kernels compare pivots against the threshold in float32
    assert float(np.float32(jl._thresh())) == tl._thresh()

    # level order and the initial pool (the port keeps nslots + 2 rows;
    # the JAX package bucket-pads with zero rows)
    jlv, tlv = jbl.level_order(jp), tbl.level_order(tp)
    for k in jlv:
        np.testing.assert_array_equal(np.asarray(jlv[k]),
                                      np.asarray(tlv[k]), err_msg=k)
    jpool = np.asarray(jbl.init_pool(jp, jA3.data, np.float32))
    tpool = tbl.init_pool(tp, tA3.data, np.float32, "cpu").numpy()
    ns = tp.nslots + 2
    np.testing.assert_array_equal(jpool[:ns], tpool)
    assert not jpool[ns:].any()


def test_native_engine_loads():
    from superlu_dist_tpu_torch.ops.host.native import get_lib
    assert get_lib() is not None
