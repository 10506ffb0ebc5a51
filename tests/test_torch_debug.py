"""The port's debug utilities (``utils/debug.py``) against the JAX
package's on the same float64 factor, and the env-gated
``SLU_TPU_CHECKLU`` / ``SLU_TPU_WRITELU`` hooks of every driver (the
single-device one, the 2D and 3D grids, the batch and the composite
batch), all on the CPU."""

import io

import numpy as np
import pytest
import scipy.sparse as sp

import superlu_dist_tpu as J
import superlu_dist_tpu_torch as T
from superlu_dist_tpu.utils import debug as jdebug
from superlu_dist_tpu_torch.utils import debug as tdebug
from superlu_dist_tpu_torch.utils import testing as tt

#: a small block size, so the 216 rows make 14+ block columns
BS = 16


def _opts(mod, **kw):
    # the port always aligns; the JAX package stands alignment down on the
    # CPU for its fused executors unless it is forced on
    return mod.Options(**{"dtype": "float64", "block_size": BS,
                          "align_blocks": "on", **kw})


@pytest.fixture(scope="module")
def pair():
    A = tt.laplacian_3d_unsym(6)
    jlu = J.SparseLU(A, _opts(J))
    tlu = T.SparseLU(A, _opts(T), device="cpu")
    return A, jlu, tlu


def _a3(lu):
    """The permuted, scaled and aligned matrix the factor holds."""
    A3 = lu._A_orig.multiply(lu.row_scale[:, None]) \
        .multiply(lu.col_scale[None, :]).tocsc()
    A3 = A3[lu.rowperm, :][lu.colperm, :][:, lu.colperm]
    return lu._expand_A(sp.csc_matrix(A3))


def test_same_plan(pair):
    _, jlu, tlu = pair
    assert np.array_equal(np.asarray(jlu.plan.slot_row), tlu.plan.slot_row)
    assert np.array_equal(np.asarray(jlu.plan.slot_col), tlu.plan.slot_col)
    assert np.array_equal(jlu.colperm, tlu.colperm)


def test_lu_to_dense_matches_jax(pair):
    _, jlu, tlu = pair
    amax = np.abs(_a3(tlu).data).max()
    Lj, Uj = jdebug.lu_to_dense(jlu)
    Lt, Ut = tdebug.lu_to_dense(tlu)
    assert Lt.shape == Lj.shape == (tlu.plan.n, tlu.plan.n)
    assert Lt.dtype == np.float64
    assert np.abs(Lt - Lj).max() <= 1e-10 * amax
    assert np.abs(Ut - Uj).max() <= 1e-10 * amax


@pytest.mark.parametrize("given", [True, False])
def test_check_factorization(pair, given):
    _, jlu, tlu = pair
    r = tdebug.check_factorization(tlu, _a3(tlu) if given else None)
    assert r < 1e-10
    assert abs(r - jdebug.check_factorization(jlu, _a3(jlu))) < 1e-10


@pytest.mark.parametrize("tol", [0.0, 0.2, 0.5])
def test_check_zero_diagonal_matches_jax(pair, tol):
    _, jlu, tlu = pair
    assert np.array_equal(tdebug.check_zero_diagonal(tlu, tol),
                          jdebug.check_zero_diagonal(jlu, tol))


def test_dump_pattern_is_byte_equal(pair, tmp_path):
    _, jlu, tlu = pair
    tdebug.dump_pattern(tlu, tmp_path / "t.pbm")
    jdebug.dump_pattern(jlu, tmp_path / "j.pbm")
    assert (tmp_path / "t.pbm").read_bytes() == \
        (tmp_path / "j.pbm").read_bytes()


def test_lu_summary_matches_jax(pair):
    """Every line but the pool's MiB (the JAX pool is bucket-padded)."""
    _, jlu, tlu = pair
    t = tdebug.lu_summary(tlu).splitlines()
    j = jdebug.lu_summary(jlu).splitlines()
    assert t[:-1] == j[:-1]
    assert t[-1].split(",")[1] == j[-1].split(",")[1]
    assert t[-1].startswith("pool ") and "MiB" in t[-1]


def test_print_block(pair):
    _, jlu, tlu = pair
    plan = tlu.plan
    s = int(plan.diag_slot[2])
    I, J_ = int(plan.slot_row[s]), int(plan.slot_col[s])
    out = io.StringIO()
    tdebug.print_block(tlu, I, J_, file=out)
    head, *rows = out.getvalue().splitlines()
    assert head == f"block ({I},{J_}) slot {s}:"
    got = np.array([float(v) for v in " ".join(rows).replace(
        "[", " ").replace("]", " ").split()]).reshape(BS, BS)
    assert np.abs(got - tlu.pool[s].numpy()).max() <= 5e-5 * np.abs(
        got).max() + 1e-4
    zero = [(i, j) for i in range(plan.nb) for j in range(plan.nb)
            if not ((plan.slot_row == i) & (plan.slot_col == j)).any()][0]
    for mod, lu in ((tdebug, tlu), (jdebug, jlu)):
        out = io.StringIO()
        mod.print_block(lu, *zero, file=out)
        assert out.getvalue() == \
            f"block ({zero[0]},{zero[1]}): structurally zero\n"


def test_compare_lu(pair, tmp_path):
    A, _, tlu = pair
    other = T.SparseLU(A, _opts(T), device="cpu")
    tdebug.dump_lu(tlu, tmp_path / "a.npz")
    tdebug.dump_lu(other, tmp_path / "b.npz")
    assert tdebug.compare_lu(tmp_path / "a.npz", tmp_path / "b.npz")
    assert jdebug.compare_lu(tmp_path / "a.npz", tmp_path / "b.npz")
    z = np.load(tmp_path / "a.npz")
    assert z["pool"].shape == (tlu.plan.nslots + 2, BS, BS)
    assert int(z["n"]) == A.shape[0] and int(z["bs"]) == BS
    # the same pattern with other values
    other = T.SparseLU(tt.laplacian_3d_unsym(6, seed=2), _opts(T),
                       device="cpu")
    tdebug.dump_lu(other, tmp_path / "c.npz")
    assert not tdebug.compare_lu(tmp_path / "a.npz", tmp_path / "c.npz")


def test_env_hooks_single_device(monkeypatch, tmp_path):
    A = tt.laplacian_3d_unsym(5)
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    monkeypatch.setenv("SLU_TPU_WRITELU", str(tmp_path / "lu.npz"))
    res, lu = T.gssvx(A, np.ones(A.shape[0]), _opts(T), device="cpu")
    assert res.stat.counters["checklu_max_resid"] < 1e-10
    z = np.load(tmp_path / "lu.npz")
    assert np.array_equal(z["pool"], lu.pool.numpy())
    assert np.array_equal(z["colperm"], lu.colperm)


def test_env_hooks_off_by_default(monkeypatch, tmp_path):
    monkeypatch.delenv("SLU_TPU_CHECKLU", raising=False)
    monkeypatch.delenv("SLU_TPU_WRITELU", raising=False)
    lu = T.SparseLU(tt.laplacian_3d(4), _opts(T), device="cpu")
    assert "checklu_max_resid" not in lu.stat.counters


def test_env_hooks_ring_embedding(monkeypatch, tmp_path):
    """Under SLU_TPU_COMPLEX=embed the pool is the float32 factor of the
    2n real rows, which lu_to_dense returns as it stands."""
    A = tt.helmholtz_3d(4)
    monkeypatch.setenv("SLU_TPU_COMPLEX", "embed")
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    lu = T.SparseLU(A, T.Options(dtype="complex64", block_size=BS),
                    device="cpu")
    assert lu._embed
    L, U = tdebug.lu_to_dense(lu)
    assert L.dtype == np.float32 and L.shape == (lu.plan.n, lu.plan.n)
    assert lu.plan.n >= 2 * A.shape[0]
    assert lu.stat.counters["checklu_max_resid"] < 1e-5
    assert tdebug.check_factorization(lu) < 1e-5


def test_env_hooks_native_complex(monkeypatch):
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    lu = T.SparseLU(tt.helmholtz_3d(4, dtype=np.complex128),
                    _opts(T, dtype="complex128"), device="cpu")
    assert lu.stat.counters["checklu_max_resid"] < 1e-10
    assert tdebug.lu_to_dense(lu)[1].dtype == np.complex128


@pytest.mark.parametrize("grid", ["2d", "3d"])
def test_env_hooks_on_a_grid(monkeypatch, tmp_path, grid):
    """The grids inherit the hooks as the JAX package's do: WRITELU dumps
    the ranks' factors stacked in the grid's shape, and CHECKLU raises,
    as a grid's pool is sharded over its ranks."""
    A = tt.laplacian_3d(4)
    make = {"2d": lambda o: T.DistributedSparseLU(A, T.Grid2D(2, 2), o,
                                                  device="cpu"),
            "3d": lambda o: T.Distributed3DSparseLU(A, T.Grid3D(2, 2, 2), o,
                                                    device="cpu")}[grid]
    o = T.Options(dtype="float32", block_size=8)
    monkeypatch.setenv("SLU_TPU_WRITELU", str(tmp_path / "g.npz"))
    lu = make(o)
    z = np.load(tmp_path / "g.npz")
    shape = tuple(lu.grid.shape)
    assert z["pool"].shape[:len(shape)] == shape
    assert z["pool"].shape[-2:] == (8, 8)
    assert z["pool"].shape[len(shape)] == max(int(p.shape[0])
                                              for p in lu.pool)
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    with pytest.raises(ValueError, match="sharded"):
        make(o)


def test_env_hooks_batch(monkeypatch, tmp_path):
    """The batch audits its first member's factor, as the JAX package's
    runs the hooks on its prototype's factor of As[0]."""
    A = tt.laplacian_3d_unsym(4)
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    monkeypatch.setenv("SLU_TPU_WRITELU", str(tmp_path / "b.npz"))
    blu = T.BatchedSparseLU([A, 2.0 * A], _opts(T), device="cpu")
    assert blu.stat.counters["checklu_max_resid"] < 1e-10
    z = np.load(tmp_path / "b.npz")
    assert np.array_equal(z["pool"], blu.pool_b[0].numpy())
    assert blu._proto.pool is None


def test_env_hooks_gssvx_batch(monkeypatch):
    """The composite batch is one SparseLU, which inherits the hooks."""
    As = [tt.laplacian_3d_unsym(3), tt.laplacian_3d_unsym(4, seed=2)]
    bs_ = [np.ones(A.shape[0]) for A in As]
    monkeypatch.setenv("SLU_TPU_CHECKLU", "1")
    _, lu = T.gssvx_batch(As, bs_, _opts(T), device="cpu")
    assert lu.stat.counters["checklu_max_resid"] < 1e-10
