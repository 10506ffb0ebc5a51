"""The port's 2D partition (``superlu_dist_tpu_torch.parallel.dist2d``)
and the RDMA kernels' tapes against the JAX package's, exactly, on every
grid shape the 8-device test mesh holds; the kernels' own job lists
cover the plan's work once; the distributed SpMV against scipy."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from superlu_dist_tpu.ops.host.symbolic import block_symbolic as j_symbolic
from superlu_dist_tpu.parallel import dist2d as jd
from superlu_dist_tpu.parallel import dist2d_rdma as jr
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.utils.testing import random_sparse
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.parallel import dist2d as td
from superlu_dist_tpu_torch.parallel import dist2d_rdma as tr
from superlu_dist_tpu_torch.utils.testing import laplacian_2d

GRIDS = [(2, 2), (1, 4), (4, 2), (2, 4)]
MATRICES = {
    "lap2d12": lambda: laplacian_2d(12).tocsc(),
    "random_unsym": lambda: random_sparse(150, density=0.04, seed=7).tocsc(),
}
BS = 16


@pytest.fixture(scope="module", params=list(MATRICES))
def case(request):
    A = MATRICES[request.param]()
    return A, block_symbolic(A, BS), j_symbolic(A, BS)


@pytest.mark.parametrize("pr,pc", GRIDS)
def test_partition_equals_jax(case, pr, pc):
    A, plan, jplan = case
    dp, jdp = td.partition_plan(plan, pr, pc), jd.partition_plan(jplan, pr, pc)
    for f in dataclasses.fields(jd.DistPlan2D):
        a, b = getattr(dp, f.name), getattr(jdp, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert dp.comm_volume(4, 3) == jdp.comm_volume(4, 3)


@pytest.mark.parametrize("pr,pc", GRIDS)
def test_pools_and_coo_shards_equal_jax(case, pr, pc):
    A, plan, jplan = case
    dp, jdp = td.partition_plan(plan, pr, pc), jd.partition_plan(jplan, pr, pc)
    pools = td.init_local_pools(plan, dp, A.data, np.float32, "cpu")
    jpools = np.asarray(jd.init_local_pools(jplan, jdp, A, np.float32,
                                            JGrid2D(pr, pc)))
    assert len(pools) == pr * pc
    got = np.stack([p.numpy() for p in pools]).reshape(jpools.shape)
    assert np.array_equal(got, jpools)


@pytest.mark.parametrize("pr,pc", GRIDS)
def test_rdma_tapes_equal_jax(case, pr, pc):
    A, plan, jplan = case
    dp, jdp = td.partition_plan(plan, pr, pc), jd.partition_plan(jplan, pr, pc)
    rt, jrt = tr.build_rdma_recv_tapes(plan, dp), \
        jr.build_rdma_recv_tapes(jplan, jdp)
    assert rt.keys() == jrt.keys()
    for k in rt:
        assert np.array_equal(rt[k], np.asarray(jrt[k])), k
    for which in ("L", "U"):
        (t, c), (jt, jc) = tr.build_rdma_solve_tapes(plan, dp, which), \
            jr.build_rdma_solve_tapes(jplan, jdp, which)
        assert c == jc and t.keys() == jt.keys()
        for k in t:
            assert np.array_equal(t[k], np.asarray(jt[k])), (which, k)


@pytest.mark.parametrize("pr,pc", GRIDS)
def test_job_lists_cover_the_plan_once(case, pr, pc):
    """The kernels' unpadded job lists hold every diagonal step, panel
    block and Schur product of the plan once, on the rank that owns what
    the job writes, at the step's level; each sweep's products and rows
    once."""
    A, plan, _ = case
    dp = td.partition_plan(plan, pr, pc)
    ft = tr.build_factor_tapes(plan, dp, "cpu")
    h = ft.host
    assert ft.aptr[-1, -1] == plan.nb
    assert ft.bptr[-1, -1] == len(plan.l_slots) + len(plan.u_slots)
    assert h["cptr"][-1] == len(plan.g_l) == len(h["c_l"])
    own = np.asarray(dp.owner_dev)
    # every (rank, local slot) target of a level once; its rank owns it
    loc_of = {(int(own[s]), int(dp.local_slot[s])): s
              for s in range(plan.nslots)}
    lev = np.asarray(plan.step_level)
    for lvl in range(ft.nlvl):
        lo, hi = ft.sptr[lvl, 0], ft.sptr[lvl, -1]
        keys = list(zip(h["s_rank"][lo:hi], h["s_tloc"][lo:hi]))
        assert len(set(keys)) == len(keys)
        for d, t in keys:
            assert (int(d), int(t)) in loc_of
        a = slice(ft.aptr[lvl, 0], ft.aptr[lvl, -1])
        steps = [plan.slot_col[loc_of[(int(d), int(t))]] for d, t in
                 zip(h["a_rank"][a], h["a_loc"][a])]
        assert np.all(lev[steps] == lvl)
    for which, nrow in (("L", plan.lsol_gslot), ("U", plan.usol_gslot)):
        tp = tr.build_sweep_tapes(plan, dp, which, "cpu")
        assert len(tp.host["c_loc"]) == len(nrow)
        assert tp.dptr[-1, -1] == plan.nb
        assert sorted(tp.host["d_row"]) == list(range(plan.nb))
        # one partial per rank of the owner's grid row, per solved row
        assert tp.pptr[-1, -1] == plan.nb * pc


def test_dist_spmv_matches_scipy():
    A = sp.csc_matrix(random_sparse(150, density=0.04, seed=7))
    x = np.random.default_rng(3).standard_normal((150, 3))
    import torch
    for ndev in (1, 4, 8):
        shards = td.coo_shards(A, ndev, np.float64, "cpu")
        y = td.dist_spmv(shards, torch.as_tensor(x), 150).numpy()
        ref = A @ x
        assert np.abs(y - ref).max() <= 1e-13 * np.abs(ref).max()
