"""The port's CUDA kernels against their plain versions on the card.

Run on a machine with an NVIDIA GPU (the kernels build with nvcc at first
use): ``python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_cuda.py`` (the conftest pins JAX, which that machine
need not have).
Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.kernels import clk, diag_lu, sweep
from superlu_dist_tpu_torch.utils import testing as tt

pytestmark = pytest.mark.cuda

#: kernel against plain version on the same input: float32 sums in other
#: orders; 64 ulp of the output's magnitude
ULPS = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _factor_plain(pool, thresh, tp, nb):
    """``clk.factor`` through the plain version of each phase."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        clk.clk_update_plain(pool, linv, tp, level)
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[lo:hi].long(),
                              tp.dstep[lo:hi].long(), thresh, tiny)
        clk.clk_trsm_plain(pool, uinv, tp, level)
    return pool, linv, uinv, tiny


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_factor_and_sweeps_match_plain(cuda, bs):
    A = tt.laplacian_3d(12).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs),
                      device=cuda)
    assert res.berr.max() < 1e-15
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, cuda)
    kern = clk.factor(pool.clone(), lu._thresh(), tp, plan.nb)
    plain = _factor_plain(pool.clone(), lu._thresh(), tp, plan.nb)
    eps = np.finfo(np.float32).eps
    for k, p in zip(kern[:3], plain[:3]):
        scale = max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= ULPS * eps * scale
    X = torch.randn(plan.nb, plan.bs, 2, device=cuda)
    Xk = sweep.solve(lu.pool, lu.linv, lu.uinv, lu._ltape, lu._utape,
                     X.clone())
    Xp = X.clone()
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for level in range(tape.nlvl):
            sweep.sweep_level_plain(lu.pool, dinv, Xp, tape, level)
    scale = max(1.0, float(Xp.abs().max()))
    assert float((Xk - Xp).abs().max()) <= ULPS * eps * scale
