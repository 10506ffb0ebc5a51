"""Kernels 9–10 (solve_gemm, diag_apply): the port's transposed tapes
against the JAX package's ``_trans_schedule``; on a JAX-factored pool
carried across into the port, the plain transposed solve against the JAX
package's XLA transposed solve, and the plain per-level phases with both
``transpose`` flags against its Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import pallas_exec as jpe

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.ops.kernels import solve_gemm, sweep
from superlu_dist_tpu_torch.utils import testing as tt

from torch_state import numpy_state

torch.set_num_threads(2)
#: same pool, same float32 arithmetic, other summation orders: 64 ulp of
#: the solution's magnitude (as tests/test_torch_sweep.py)
ULPS = 64
MATRICES = {"lap3d8": (lambda: tt.laplacian_3d(8), 16),
            "unsym": (lambda: tt.unsymmetric_pattern(200, seed=1), 16),
            "bushy": (tt.laplacian_arrowhead, 128)}


def _carry(name):
    make, bs = MATRICES[name]
    A = make().tocsc()
    kw = dict(dtype="float32", block_size=bs)
    jlu = J.SparseLU(A, J.Options(**kw))
    tlu = T.SparseLU.from_numpy_state(numpy_state(jlu, T.Options(**kw)),
                                      device="cpu")
    return A, jlu, tlu


@pytest.fixture(scope="module", params=sorted(MATRICES))
def carried(request):
    return _carry(request.param)


@pytest.fixture(scope="module")
def bushy():
    return _carry("bushy")


def _rhs(plan, nrhs, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((plan.nb * plan.bs, nrhs)).astype(np.float32)


def _close(a, b):
    scale = max(1.0, np.abs(b).max())
    assert np.abs(a - b).max() <= ULPS * np.finfo(np.float32).eps * scale


@pytest.mark.parametrize("which", ["U", "L"])
def test_trans_tapes_match_jax(carried, which):
    """The same level for every destination row, and per level the same
    multiset of (slot, src, dst) triples, as the JAX package's schedule;
    the tape's CSR keeps its order within a destination."""
    _, jlu, _ = carried
    plan = jlu.plan
    ref = jbl._trans_schedule(plan, which)
    got = tbl.trans_schedule(plan, which)
    for g, r in zip(got, ref):
        assert np.array_equal(np.asarray(g), np.asarray(r))
    gptr, gs, gr, gd, dptr, diag, nlvl = ref
    level = np.empty(plan.nb, dtype=np.int64)
    level[diag] = np.repeat(np.arange(nlvl), np.diff(dptr))
    tape = solve_gemm.build_trans_tape(plan, which, "cpu")
    h = tape.host
    assert tape.nlvl == nlvl
    for l in range(nlvl):
        lo, hi = int(tape.dptr[l]), int(tape.dptr[l + 1])
        rows = h["rows"][lo:hi]
        assert np.all(level[rows] == l)
        c = slice(int(h["rowptr"][lo]), int(h["rowptr"][hi]))
        dst = np.repeat(rows, np.diff(h["rowptr"][lo:hi + 1]))
        mine = list(zip(h["cslot"][c].tolist(), h["csrc"][c].tolist(),
                        dst.tolist()))
        s = slice(int(gptr[l]), int(gptr[l + 1]))
        theirs = list(zip(gs[s].tolist(), gr[s].tolist(), gd[s].tolist()))
        assert sorted(mine) == sorted(theirs)
        # within one destination, the JAX package's order
        for J_ in np.unique(dst):
            assert [t for t in mine if t[2] == J_] == \
                [t for t in theirs if t[2] == J_]


@pytest.mark.parametrize("nrhs", [1, 3])
def test_plain_transposed_solve_matches_jax_xla(carried, nrhs):
    _, jlu, tlu = carried
    plan = jlu.plan
    b = _rhs(plan, nrhs)
    tu = solve_gemm.build_trans_tape(plan, "U", "cpu")
    tl = solve_gemm.build_trans_tape(plan, "L", "cpu")
    X = torch.from_numpy(b.copy()).view(plan.nb, plan.bs, nrhs)
    solve_gemm.solve_transposed(tlu.pool, tlu.uinv, tlu.linv, tu, tl, X)
    nbp = jbl.bucket125(plan.nb)
    bp = np.zeros((nbp * plan.bs, nrhs), np.float32)
    bp[: len(b)] = b
    ref = jbl.build_trans_solve_fn(plan, nrhs)(
        jlu.pool, jlu.uinv, jlu.linv, jbl.make_trans_solve_tapes(plan, "U"),
        jbl.make_trans_solve_tapes(plan, "L"), jnp.asarray(bp))
    _close(X.reshape(-1, nrhs).numpy(), np.asarray(ref)[: len(b)])


def _pallas_levels(plan, which, C):
    """A transposed sweep's window-scheduled tapes, as
    ``pallas_exec.pallas_solve_meta`` builds them for the NOTRANS sweeps
    (fillers read the zero block and hit the trash row of X)."""
    nbp = jbl.bucket125(plan.nb)
    gptr, gs, gr, gd, dptr, diag, nlvl = jbl._trans_schedule(plan, which)
    ws, wr, wd, wptr = jpe.window_schedule(gs, gr, gd, gptr, C,
                                           plan.zero_slot, nbp)
    wr = np.where(wd == nbp, 0, wr).astype(np.int32)
    grid_g = max(1, -(-int(np.diff(wptr).max(initial=1)) // C))
    grid_d = max(1, -(-int(np.diff(dptr).max(initial=1)) // C))
    return (nlvl, wptr, dptr, jnp.asarray(ws), jnp.asarray(wr),
            jnp.asarray(wd), jnp.asarray(diag.astype(np.int32)), grid_g,
            grid_d)


def test_transpose_true_matches_pallas_kernels(bushy):
    """Level by level, the port's plain solve_gemm and diag_apply with
    ``transpose=True`` against the JAX package's Pallas kernels with
    ``transpose=True`` (interpret mode), each from the same X."""
    _, jlu, tlu = bushy
    plan = jlu.plan
    C, W, nrhs = 4, 128, 2
    nbp = jbl.bucket125(plan.nb)
    b = _rhs(plan, nrhs)
    X = torch.from_numpy(b.copy()).view(plan.nb, plan.bs, nrhs)
    for which, jinv, tinv in (("U", jlu.uinv, tlu.uinv),
                              ("L", jlu.linv, tlu.linv)):
        nlvl, wptr, dptr, ws, wr, wd, diag, grid_g, grid_d = \
            _pallas_levels(plan, which, C)
        gcall = jpe.make_solve_gemm_call(grid_g, C, W, True, transpose=True,
                                         interpret=True)
        dcall = jpe.make_diag_apply_call(grid_d, C, W, True, transpose=True,
                                         interpret=True)
        tape = solve_gemm.build_trans_tape(plan, which, "cpu")
        for l in range(nlvl):
            xw = np.zeros((nbp + 1, plan.bs, W), np.float32)
            xw[: plan.nb, :, :nrhs] = X.numpy()
            xw = gcall(jlu.pool, jnp.asarray(xw),
                       jnp.asarray([wptr[l], wptr[l + 1]], jnp.int32),
                       ws, wr, wd)
            solve_gemm.solve_gemm(tlu.pool, X, tape, l, True)
            _close(X.numpy(), np.asarray(xw)[: plan.nb, :, :nrhs])
            xw = dcall(jlu.pool, jinv, xw,
                       jnp.asarray([dptr[l], dptr[l + 1]], jnp.int32), diag)
            solve_gemm.diag_apply(tinv, X, tape, l, True)
            _close(X.numpy(), np.asarray(xw)[: plan.nb, :, :nrhs])


def test_transpose_false_matches_pallas_solve(bushy):
    """With ``transpose=False`` on the plan's L and U tapes, the plain
    phases against the JAX package's Pallas level-set solve
    (``build_solve_fn_pallas``: kernels 9 and 10, interpret mode)."""
    _, jlu, tlu = bushy
    plan = jlu.plan
    nrhs = 2
    b = _rhs(plan, nrhs)
    X = torch.from_numpy(b.copy()).view(plan.nb, plan.bs, nrhs)
    for tape, dinv in ((tlu._ltape, tlu.linv), (tlu._utape, tlu.uinv)):
        for l in range(tape.nlvl):
            solve_gemm.solve_gemm(tlu.pool, X, tape, l, False)
            solve_gemm.diag_apply(dinv, X, tape, l, False)
    fn, (tl, tu), W = jpe.build_solve_fn_pallas(plan, nrhs, chunk=4,
                                                interpret=True)
    nbp = jbl.bucket125(plan.nb)
    bw = np.zeros((nbp * plan.bs, W), np.float32)
    bw[: len(b), :nrhs] = b
    ref = fn(jlu.pool, jlu.linv, jlu.uinv, tl, tu, jnp.asarray(bw))
    _close(X.reshape(-1, nrhs).numpy(), np.asarray(ref)[: len(b), :nrhs])


def test_transpose_false_composes_to_the_sweep(carried):
    """solve_gemm then diag_apply with ``transpose=False`` is the NOTRANS
    level sweep of sweep.py, operation for operation."""
    _, jlu, tlu = carried
    plan = jlu.plan
    X = torch.from_numpy(_rhs(plan, 2)).view(plan.nb, plan.bs, 2)
    Y = X.clone()
    for tape, dinv in ((tlu._ltape, tlu.linv), (tlu._utape, tlu.uinv)):
        for l in range(tape.nlvl):
            solve_gemm.solve_gemm(tlu.pool, X, tape, l, False)
            solve_gemm.diag_apply(dinv, X, tape, l, False)
            sweep.sweep_level_plain(tlu.pool, dinv, Y, tape, l)
            assert torch.equal(X, Y)


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_phases_by_hand(transpose):
    """Each plain phase against a Python loop over its triples and rows,
    in float64."""
    rng = np.random.default_rng(4)
    nb, bs, k = 5, 8, 3
    pool = torch.as_tensor(rng.standard_normal((7, bs, bs)))
    dinv = torch.as_tensor(rng.standard_normal((nb, bs, bs)))
    X = torch.as_tensor(rng.standard_normal((nb, bs, k)))
    # level 0: rows 0, 3; level 1: rows 1, 4 (sources at level 0); row 2
    # at level 1 without contributions
    tape = sweep.csr_tape(nb, gslot=[2, 5, 1], gsrc=[0, 3, 0],
                          gdst=[4, 1, 1], dptr=[0, 2, 5],
                          rows=[0, 3, 1, 2, 4], nlvl=2, device="cpu")

    def op(M):
        return M.T if transpose else M

    want = X.clone()
    for s, src, dst in ((5, 3, 1), (1, 0, 1), (2, 0, 4)):
        want[dst] -= op(pool[s]) @ want[src]
    for r in (1, 2, 4):
        want[r] = op(dinv[r]) @ want[r]
    solve_gemm.solve_gemm(pool, X, tape, 1, transpose)
    solve_gemm.diag_apply(dinv, X, tape, 1, transpose)
    assert torch.allclose(X, want, rtol=1e-13, atol=1e-13)
    # a level without contributions leaves X as it is
    Y = X.clone()
    solve_gemm.solve_gemm(pool, Y, tape, 0, transpose)
    assert torch.equal(X, Y)
