"""Two processes of the port on one grid (the scenarios of
``tests/test_multihost.py``), shared by ``tests/test_torch_multihost.py``
and ``tests/test_torch_multihost3d.py``.

:class:`Workers` starts two worker processes of this file (``python
tests/torch_multihost.py SCENARIO PID PORT OUTDIR DEVICE``), each of
which connects with ``multihost.initialize`` on a free local port, owns
4 of the grid's 8 ranks on the CPU (the plain versions, in turns,
through shared-memory files under OUTDIR; block size 16) or on the card
(CUDA IPC; block size 32, the smallest the kernels take), runs the
scenario, asserts what one
process can see (the JAX test's guards, the receive counters against
the tapes) and saves what the test compares across processes and
against the single-process runs: x, refinement steps, every rank's pools
and the plan's checksum. A worker imports the port only.
"""

import dataclasses
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
#: the block size of the scenarios on each device
BLOCK = {"cpu": 16, "cuda": 32}
#: the device of a worker's ranks (the fifth argument)
DEVICE = "cpu"


def plan_sha(plan) -> str:
    """The plan's checksum over every field but the value placement
    ``init_idx`` (the JAX test's)."""
    h = hashlib.sha256()
    for f in sorted(f.name for f in dataclasses.fields(plan)):
        if f != "init_idx":
            h.update(np.ascontiguousarray(
                np.asarray(getattr(plan, f))).tobytes())
    return h.hexdigest()


def system(k: int = 12):
    """laplacian_2d(k), the seed-7 solution and its right-hand side."""
    from superlu_dist_tpu_torch.utils.testing import laplacian_2d
    A = laplacian_2d(k).tocsc()
    xt = np.random.default_rng(7).standard_normal(A.shape[0])
    return A, xt, np.asarray(A @ xt)


def pools_of(lu) -> np.ndarray:
    """Every rank's pool, read through the window."""
    return np.stack([p.cpu().numpy() for p in lu.pool])


class Workers:
    """Two worker processes running ``scenario`` with their ranks on
    ``device``; :meth:`results` waits for them and loads what they saved.
    Leaving the ``with`` block kills a worker still running (a test that
    failed before :meth:`results`), so none outlives its test."""

    def __init__(self, tmp_path, scenario: str, device: str = "cpu",
                 timeout: float = 120.0):
        self.tmp_path, self.scenario, self.timeout = tmp_path, scenario, \
            timeout
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["TMPDIR"] = str(tmp_path)
        env["OMP_NUM_THREADS"] = "2"
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multihost.py"),
             scenario, str(pid), str(port), str(tmp_path), device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for pid in range(2)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def results(self) -> list:
        """A dict of saved arrays per process, in process order. A worker
        that fails or outlives the timeout fails the test."""
        outs = []
        for p in self.procs:
            try:
                outs.append(p.communicate(timeout=self.timeout)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"a worker outlived {self.timeout} s")
        name = self.scenario.upper()
        for pid, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0 and f"{name}_OK pid={pid}" in out, \
                "".join(f"process {q}:\n{o}\n" for q, o in enumerate(outs))
        return [dict(np.load(os.path.join(self.tmp_path, f"p{pid}.npz")))
                for pid in range(2)]


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------


def _check_recv(lu) -> None:
    """The puts of the factor and of the last solve, as the tapes count
    them (every rank's counters, read through the window)."""
    for k, v in lu.factor_recv().items():
        assert np.array_equal(v, lu._ft.recv[k]), k
    for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
        for k, v in got.items():
            assert np.array_equal(v, tp.recv[k]), (tp.which, k)


def _local(A, pid):
    """This process's half of A's rows as a local NRLocMatrix."""
    import scipy.sparse as sp
    from superlu_dist_tpu_torch import NRLocMatrix
    n = A.shape[0]
    Ar = sp.csr_matrix(A)
    lo, hi = (0, n // 2) if pid == 0 else (n // 2, n)
    return NRLocMatrix([(lo, Ar[lo:hi])], n, local=True), Ar[lo:hi].nnz


def _guard(calls, obj, name):
    """Record every call of ``obj.name`` in ``calls``."""
    orig = getattr(obj, name)

    def guarded(*a, **k):
        calls.append(name)
        return orig(*a, **k)
    setattr(obj, name, guarded)


def _opts(device=None, **kw):
    """The scenarios' Options on ``device`` (default: this worker's)."""
    from superlu_dist_tpu_torch import Options
    return Options(dtype="float32", block_size=BLOCK[device or DEVICE], **kw)


def _planning_opts(device=None):
    from superlu_dist_tpu_torch.utils.options import ColPerm, Equil, RowPerm
    return _opts(device, dist_planning=True, equil=Equil.NO,
                 row_perm=RowPerm.NOROWPERM, col_perm=ColPerm.NATURAL)


def mesh2d(pid, out):
    import superlu_dist_tpu_torch as T
    A, xt, b = system()
    res, lu = T.gssvx_dist(A, b, T.Grid2D(2, 4), _opts(), device=DEVICE)
    assert float(res.berr.max()) < 1e-13, res.berr
    # preprocessing ran only on process 0 (broadcast elsewhere)
    assert (res.stat.utime.get("ROWPERM", 0.0) > 0.0) == (pid == 0)
    _check_recv(lu)
    out.update(x=res.x, steps=res.stat.refine_steps, pools=pools_of(lu))


def nrloc(pid, out):
    import superlu_dist_tpu_torch as T
    from superlu_dist_tpu_torch.utils import nrloc as nrloc_mod
    A, xt, b = system()
    Aloc, nnz = _local(A, pid)
    calls = []
    _guard(calls, nrloc_mod.NRLocMatrix, "to_global")
    res, lu = T.gssvx_dist(Aloc, b, T.Grid2D(2, 4), _opts(), device=DEVICE)
    assert float(res.berr.max()) < 1e-13, res.berr
    assert not calls, "to_global must never run in sharded mode"
    if pid != 0:
        # host memory holds only the local rows
        assert lu._A_orig.nnz == nnz, lu._A_orig.nnz
    _check_recv(lu)
    out.update(x=res.x, steps=res.stat.refine_steps, pools=pools_of(lu))


def mesh3d(pid, out):
    import superlu_dist_tpu_torch as T
    A, xt, b = system()
    res, lu = T.gssvx3d(A, b, T.Grid3D(2, 2, 2), _opts(), device=DEVICE)
    assert float(res.berr.max()) < 1e-13, res.berr
    assert (res.stat.utime.get("ROWPERM", 0.0) > 0.0) == (pid == 0)
    _check_recv(lu)
    out.update(x=res.x, steps=res.stat.refine_steps, pools=pools_of(lu))
    # the transposed solve across the grid's processes
    out["xT"] = lu.solve(np.asarray(A.T @ xt), trans=T.Trans.TRANS)
    # sharded NRLoc input on the 3D grid: this process's rows only
    Aloc, nnz = _local(A, pid)
    res3, lu3 = T.gssvx3d(Aloc, b, T.Grid3D(2, 2, 2), _opts(),
                          device=DEVICE)
    if pid != 0:
        assert lu3._A_orig.nnz == nnz
    out.update(x3=res3.x, steps3=res3.stat.refine_steps,
               pools3=pools_of(lu3))
    # a checkpoint of the 3D grid (owner-gather through the window) that
    # process 0 writes and loads as a single-device SparseLU
    path = os.path.join(os.path.dirname(out["_path"]), "ckpt3d.npz")
    T.save_factors(lu, path)
    if pid == 0:
        one = T.load_factors(path, device=DEVICE)
        xl, _ = one.refine(b, one.solve(b))
        out["xl"] = xl


def reuse(pid, out):
    import superlu_dist_tpu_torch as T
    from superlu_dist_tpu_torch.utils import nrloc as nrloc_mod
    A, xt, b = system()
    calls = []
    _guard(calls, nrloc_mod.NRLocMatrix, "to_global")
    lu = T.DistributedSparseLU(_local(A, pid)[0], T.Grid2D(2, 4), _opts(),
                               device=DEVICE)
    x, _ = lu.refine(b, lu.solve(b))
    xs = [x]
    for fact, A2 in reuse_matrices(A):
        lu.refactor(_local(A2, pid)[0], fact=fact)
        b2 = np.asarray(A2 @ xt)
        x2, berr2 = lu.refine(b2, lu.solve(b2))
        assert float(berr2.max()) < 1e-13, (fact, berr2)
        xs.append(x2)
    assert not calls, "to_global must never run in sharded mode"
    _check_recv(lu)
    out.update(x=np.stack(xs), pools=pools_of(lu))
    rows = lu.profile_levels()
    assert len(rows) > 0 and all("ms" in r for r in rows)
    # the profiled factors are the live ones, bit-equal to the last
    assert np.array_equal(pools_of(lu), out["pools"])
    path = os.path.join(os.path.dirname(out["_path"]), "ckpt2d.npz")
    T.save_factors(lu, path)
    if pid == 0:
        assert os.path.exists(path)


def reuse_matrices(A):
    """The refactors of the reuse scenario: SamePattern_SameRowPerm with
    A·1.5, then SamePattern with A's values scaled by a ramp."""
    import scipy.sparse as sp
    from superlu_dist_tpu_torch.utils.options import Fact
    A2 = A.copy()
    A2.data = A2.data * 1.5
    A3 = A.copy()
    A3.data = A3.data * np.linspace(0.5, 2.0, A.nnz)
    A3 = sp.csc_matrix((A3.data, A3.indices, A3.indptr), shape=A.shape)
    return [(Fact.SAME_PATTERN_SAME_ROWPERM, A2), (Fact.SAME_PATTERN, A3)]


def _planning(pid, out, grid, k):
    import superlu_dist_tpu_torch as T
    from superlu_dist_tpu_torch.parallel import dist2d as dist2d_mod
    from superlu_dist_tpu_torch.utils import nrloc as nrloc_mod
    A, xt, b = system(k)
    Aloc, nnz = _local(A, pid)
    # neither the global values nor the global pattern on ANY process
    calls = []
    _guard(calls, nrloc_mod.NRLocMatrix, "to_global")
    _guard(calls, dist2d_mod, "gather_values_to0")
    cls = T.Distributed3DSparseLU if isinstance(grid, T.Grid3D) \
        else T.DistributedSparseLU
    lu = cls(Aloc, grid, _planning_opts(), device=DEVICE)
    x, berr = lu.refine(b, lu.solve(b))
    assert float(berr.max()) < 1e-13, berr
    assert not calls, f"global pattern/value gather ran: {calls}"
    assert lu._A_orig.nnz == nnz          # only local rows held
    assert len(lu.plan.init_idx) == 0     # no global value placement
    _check_recv(lu)
    out.update(x=x, steps=lu.stat.refine_steps, pools=pools_of(lu),
               sha=plan_sha(lu.plan),
               blocks=lu.stat.counters["dist_planning_blocks"])


def refusals(pid, out):
    """Each process owns a contiguous share of the ranks; a grid whose
    ranks do not split evenly over the processes raises ValueError;
    processes on different cards raise naming item 8d."""
    import pytest
    import superlu_dist_tpu_torch as T
    from superlu_dist_tpu_torch.parallel import multihost as mh
    A, xt, b = system(6)
    grid = T.Grid3D(2, 2, 2)
    assert list(grid.owned_ranks()) == list(range(4 * pid, 4 * pid + 4))
    assert [grid.process_of(d) for d in range(8)] == [0] * 4 + [1] * 4
    with pytest.raises(ValueError, match="split evenly"):
        T.gssvx_dist(A, b, T.Grid2D(1, 3), _opts(), device=DEVICE)
    key = mh.device_key
    mh.device_key = lambda dev: f"card{pid}"
    with pytest.raises(NotImplementedError, match="queue 1 item 8d"):
        T.gssvx3d(A, b, T.Grid3D(2, 1, 1), _opts(), device=DEVICE)
    mh.device_key = key
    res, _ = T.gssvx_dist(A, b, T.Grid2D(1, 2), _opts(), device=DEVICE)
    out.update(x=res.x)


def planning2d(pid, out):
    import superlu_dist_tpu_torch as T
    _planning(pid, out, T.Grid2D(2, 4), 12)


def planning3d(pid, out):
    import superlu_dist_tpu_torch as T
    _planning(pid, out, T.Grid3D(2, 2, 2), 10)


def _main(scenario, pid, port, outdir, device):
    global DEVICE
    DEVICE = device
    import torch
    torch.set_num_threads(2)
    from superlu_dist_tpu_torch.parallel import multihost as mh
    pid = int(pid)
    mh.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    path = os.path.join(outdir, f"p{pid}.npz")
    out = {"_path": path}
    globals()[scenario](pid, out)
    del out["_path"]
    np.savez(path, **out)
    mh.barrier()
    print(f"{scenario.upper()}_OK pid={pid}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _main(*sys.argv[1:6])
