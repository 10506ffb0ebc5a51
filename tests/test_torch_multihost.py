"""The port's 2D grid split over two processes on the CPU: the scenarios
of ``tests/test_multihost.py`` (the whole A on both, sharded NRLoc input,
and sharded input through the ``Fact`` modes, ``profile_levels`` and a
checkpoint), run by ``tests/torch_multihost.py``'s workers, each owning 4
of the 8 ranks of ``Grid2D(2, 4)``.

Each case holds, in each process: x within 1e-10·max|x| of the JAX
package's single-process grid (its XLA executor on the 8-device test
mesh), bit-equal between the two processes with equal refinement steps,
and bit-equal to the port's single-process grid, whose pools the
processes' pools equal bit for bit (each job reads the same inputs and
sums in the same order). The workers assert the JAX test's guards and the
receive counters against the tapes themselves."""

import numpy as np

import superlu_dist_tpu as J
from superlu_dist_tpu.models.dist_driver import DistributedSparseLU as JDist
from superlu_dist_tpu.models.dist_driver import gssvx_dist as j_gssvx_dist
from superlu_dist_tpu.parallel.grid import Grid2D as JGrid2D
import superlu_dist_tpu_torch as T
import torch_multihost as tm

BS = tm.BLOCK["cpu"]


def _jopts():
    return J.Options(dtype="float32", block_size=BS)


def _close(x, ref):
    assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()


def _same(got, x, steps, pools):
    """Both processes' x, steps and pools bit-equal to one process's."""
    for r in got:
        assert np.array_equal(r["x"], x)
        assert int(r["steps"]) == steps
        assert np.array_equal(r["pools"], pools)


def _one_process(A, b):
    res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 4), tm._opts("cpu"),
                           device="cpu")
    return res, tm.pools_of(lu)


def test_two_process_grid(tmp_path):
    with tm.Workers(tmp_path, "mesh2d") as w:
        A, xt, b = tm.system()
        jres, _ = j_gssvx_dist(A, b, JGrid2D(2, 4), _jopts())
        res, pools = _one_process(A, b)
        got = w.results()
    _same(got, res.x, res.stat.refine_steps, pools)
    _close(got[0]["x"], jres.x)


def test_two_process_nrloc_sharded(tmp_path):
    """Each process passes only its half of A's rows; process 0 gathers
    the values, the others never hold them; the pools and x are the whole
    A's on one process."""
    with tm.Workers(tmp_path, "nrloc") as w:
        A, xt, b = tm.system()
        jres, _ = j_gssvx_dist(A, b, JGrid2D(2, 4), _jopts())
        res, pools = _one_process(A, b)
        got = w.results()
    _same(got, res.x, res.stat.refine_steps, pools)
    _close(got[0]["x"], jres.x)


def test_two_process_nrloc_reuse_and_checkpoint(tmp_path):
    """Sharded input through DOFACT, SamePattern_SameRowPerm and
    SamePattern: each x bit-equal to one process's and near the JAX
    package's; the two-process checkpoint (written by process 0 from the
    owner-gather through the window) loads as a single-device SparseLU and
    equals the single-process grid's checkpoint array for array."""
    with tm.Workers(tmp_path, "reuse") as w:
        A, xt, b = tm.system()
        jlu = JDist(A, JGrid2D(2, 4), _jopts())
        lu = T.DistributedSparseLU(A, T.Grid2D(2, 4), tm._opts("cpu"),
                                   device="cpu")
        jxs = [jlu.refine(b, jlu.solve(b))[0]]
        xs = [lu.refine(b, lu.solve(b))[0]]
        for fact, A2 in tm.reuse_matrices(A):
            b2 = np.asarray(A2 @ xt)
            jlu.refactor(A2, fact=J.Fact(fact.value))
            lu.refactor(A2, fact=fact)
            jxs.append(jlu.refine(b2, jlu.solve(b2))[0])
            xs.append(lu.refine(b2, lu.solve(b2))[0])
        one = tmp_path / "one.npz"
        T.save_factors(lu, one)
        got = w.results()
    for r in got:
        assert np.array_equal(r["x"], np.stack(xs))
        assert np.array_equal(r["pools"], tm.pools_of(lu))
    for x, jx in zip(got[0]["x"], jxs):
        _close(x, jx)
    two, ref = np.load(tmp_path / "ckpt2d.npz"), np.load(one)
    assert sorted(two.files) == sorted(ref.files)
    for k in ref.files:
        assert np.array_equal(two[k], ref[k]), k
    loaded = T.load_factors(tmp_path / "ckpt2d.npz", device="cpu")
    assert type(loaded) is T.SparseLU
    b3 = np.asarray(tm.reuse_matrices(A)[-1][1] @ xt)
    x, berr = loaded.refine(b3, loaded.solve(b3))
    assert berr.max() < 1e-13
    _close(x, xs[-1])


def test_two_process_refusals(tmp_path):
    """Ranks that do not split evenly over the processes, and processes on
    different cards (item 8d), are refused; a 1x2 grid then still runs,
    one rank a process, to one process's x."""
    with tm.Workers(tmp_path, "refusals") as w:
        A, xt, b = tm.system(6)
        res, _ = T.gssvx_dist(A, b, T.Grid2D(1, 2), tm._opts("cpu"),
                              device="cpu")
        got = w.results()
    for r in got:
        assert np.array_equal(r["x"], res.x)
