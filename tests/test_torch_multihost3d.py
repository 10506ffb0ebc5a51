"""The port's grids split over two processes on the CPU, continued: the
3D grid (``Grid3D(2, 2, 2)``, one layer a process: its transposed solve,
sharded NRLoc input and a checkpoint) and distributed planning on the 2D
and the 3D grid (the scenarios of ``tests/test_multihost.py``), run by
``tests/torch_multihost.py``'s workers. The tolerances and the checks
are ``tests/test_torch_multihost.py``'s. Under ``dist_planning`` the
plan's checksum (every field but ``init_idx``) equals the serial plan's
of both packages, and the port's single-process reference runs the same
options with ``align_blocks="off"``, which builds that serial plan (the
distributed plan is never aligned: no process holds the pattern that
alignment reads)."""

import numpy as np

import superlu_dist_tpu as J
from superlu_dist_tpu.models.dist_driver import DistributedSparseLU as JDist
from superlu_dist_tpu.models.driver3d import Distributed3DSparseLU as JDist3
from superlu_dist_tpu.models.driver3d import gssvx3d as j_gssvx3d
from superlu_dist_tpu.ops.host.symbolic import block_symbolic as j_symbolic
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
from superlu_dist_tpu.parallel.grid import Grid3D as JGrid3D
import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
import torch_multihost as tm
from test_torch_multihost import BS, _close, _jopts


def test_two_process_3d_grid(tmp_path):
    with tm.Workers(tmp_path, "mesh3d") as w:
        A, xt, b = tm.system()
        jres, _ = j_gssvx3d(A, b, JGrid3D(2, 2, 2), _jopts())
        res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), tm._opts("cpu"),
                            device="cpu")
        xT = lu.solve(np.asarray(A.T @ xt), trans=T.Trans.TRANS)
        one = tmp_path / "one.npz"
        T.save_factors(lu, one)
        loaded = T.load_factors(one, device="cpu")
        xl, _ = loaded.refine(b, loaded.solve(b))
        got = w.results()
    for r in got:
        # the whole A and the sharded input give one process's bits
        for x, steps, pools in (("x", "steps", "pools"),
                                ("x3", "steps3", "pools3")):
            assert np.array_equal(r[x], res.x), x
            assert int(r[steps]) == res.stat.refine_steps
            assert np.array_equal(r[pools], tm.pools_of(lu)), pools
        assert np.array_equal(r["xT"], xT)
    _close(got[0]["x"], jres.x)
    two, ref = np.load(tmp_path / "ckpt3d.npz"), np.load(one)
    for k in ref.files:
        assert np.array_equal(two[k], ref[k]), k
    assert np.array_equal(got[0]["xl"], xl)


def _planning(tmp_path, scenario, grid, jcls, jgrid, k):
    with tm.Workers(tmp_path, scenario) as w:
        A, xt, b = tm.system(k)
        jo = J.Options(dtype="float32", block_size=BS, dist_planning=True,
                       equil=J.Equil.NO, row_perm=J.RowPerm.NOROWPERM,
                       col_perm=J.ColPerm.NATURAL)
        jlu = jcls(A, jgrid, jo)
        jx, _ = jlu.refine(b, jlu.solve(b))
        cls = T.Distributed3DSparseLU if isinstance(grid, T.Grid3D) \
            else T.DistributedSparseLU
        lu = cls(A, grid,
                 tm._planning_opts("cpu").replace(align_blocks="off"),
                 device="cpu")
        x, _ = lu.refine(b, lu.solve(b))
        got = w.results()
    sha = tm.plan_sha(block_symbolic(A, BS))
    assert sha == tm.plan_sha(j_symbolic(A, BS)) == tm.plan_sha(lu.plan)
    for r in got:
        assert str(r["sha"]) == sha
        assert np.array_equal(r["x"], x)
        assert int(r["steps"]) == lu.stat.refine_steps
        assert np.array_equal(r["pools"], tm.pools_of(lu))
    assert int(got[0]["blocks"]) == int(got[1]["blocks"])
    _close(got[0]["x"], jx)


def test_two_process_distributed_planning(tmp_path):
    """No process gathers the global values or pattern; the plan from the
    allgathered block keys is the serial plan."""
    _planning(tmp_path, "planning2d", T.Grid2D(2, 4), JDist, JGrid2D(2, 4),
              12)


def test_two_process_distributed_planning_3d(tmp_path):
    _planning(tmp_path, "planning3d", T.Grid3D(2, 2, 2), JDist3,
              JGrid3D(2, 2, 2), 10)
