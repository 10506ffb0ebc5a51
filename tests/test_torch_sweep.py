"""Kernel 3 (sweep): on a JAX-factored pool carried across into the
port, the NOTRANS solve (``solve_gemm.solve``, whose CPU path runs the
plain levels) against the JAX package's whole-sweep kernel (interpret
mode) and its XLA level-set solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import pallas_exec as jpe

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops.kernels import solve_gemm
from superlu_dist_tpu_torch.utils import testing as tt

from torch_state import numpy_state

torch.set_num_threads(2)
#: same pool, same float32 arithmetic, other summation orders: 64 ulp of
#: the solution's magnitude (measured below 8)
ULPS = 64


@pytest.fixture(scope="module", params=["lap3d8", "unsym"])
def carried(request):
    A = {"lap3d8": tt.laplacian_3d(8),
         "unsym": tt.unsymmetric_pattern(200, seed=1)}[request.param]
    kw = dict(dtype="float32", block_size=16)
    jlu = J.SparseLU(A.tocsc(), J.Options(**kw))
    tlu = T.SparseLU.from_numpy_state(numpy_state(jlu, T.Options(**kw)),
                                      device="cpu")
    return A, jlu, tlu


def _rhs(plan, nrhs, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((plan.nb * plan.bs, nrhs)).astype(np.float32)


def _close(a, b):
    scale = max(1.0, np.abs(b).max())
    assert np.abs(a - b).max() <= ULPS * np.finfo(np.float32).eps * scale


@pytest.mark.parametrize("nrhs", [1, 3])
def test_sweep_matches_jax_solvers(carried, nrhs):
    _, jlu, tlu = carried
    plan = jlu.plan
    b = _rhs(plan, nrhs)
    X = torch.from_numpy(b.copy()).view(plan.nb, plan.bs, nrhs)
    solve_gemm.solve(tlu.pool, tlu.linv, tlu.uinv, tlu._ltape, tlu._utape,
                     X)
    got = X.reshape(-1, nrhs).numpy()

    nbp = jbl.bucket125(plan.nb)
    bp = np.zeros((nbp * plan.bs, nrhs), np.float32)
    bp[: len(b)] = b
    xla = jbl.build_solve_fn(plan, nrhs)(
        jlu.pool, jlu.linv, jlu.uinv, jbl.make_solve_tapes(plan, "L"),
        jbl.make_solve_tapes(plan, "U"), jnp.asarray(bp))
    _close(got, np.asarray(xla)[: len(b)])

    fn, (tl, tu), W = jpe.build_solve_fn_pallas_fused(plan, nrhs,
                                                      interpret=True)
    bw = np.zeros((nbp * plan.bs, W), np.float32)
    bw[: len(b), :nrhs] = b
    fused = fn(jlu.pool, jlu.linv, jlu.uinv, tl, tu, jnp.asarray(bw))
    _close(got, np.asarray(fused)[: len(b), :nrhs])


def test_carried_solve_matches_jax(carried):
    """The whole solve (transforms + sweeps) on carried factors."""
    A, jlu, tlu = carried
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.shape[0])
    _close(tlu.solve(b), np.asarray(jlu.solve(b)))


def test_carried_refine_reaches_double(carried):
    A, jlu, tlu = carried
    rng = np.random.default_rng(6)
    b = rng.standard_normal(A.shape[0])
    x, berr = tlu.refine(b, tlu.solve(b))
    assert berr.max() < 1e-14
    assert np.abs(A @ x - b).max() / np.abs(b).max() < 1e-12
