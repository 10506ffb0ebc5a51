"""The port's ``gssvx`` on the CPU (plain versions of the kernels)
against the JAX package's ``gssvx`` on the CPU, end to end: solution,
backward error, refinement steps and tiny-pivot count, for the clk, flk
(exact and ILU(k)), tck, level and ``"xla"`` executors and float64; the
per-level factor profile; and the port's refusals (no silent CPU
fallback, unported options raise), with the options that it refused in
earlier slices now running."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superlu_dist_tpu as J

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.models import driver as tdrv
from superlu_dist_tpu_torch.utils import testing as tt

from torch_state import numpy_state

torch.set_num_threads(2)

CASES = {
    "lap2d12": (lambda: tt.laplacian_2d(12), 16),
    "unsym": (lambda: tt.unsymmetric_pattern(200, seed=1), 16),
    "fem3d": (lambda: tt.fem3d_delaunay(150, seed=1), 32),
    "kkt": (lambda: tt.kkt_system(200, seed=2), 16),
    "circuit": (lambda: tt.circuit_graph(400, seed=3), 32),
    "aniso2d": (lambda: tt.aniso2d(16), 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gssvx_matches_jax(name):
    make, bs = CASES[name]
    A = make().tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rj, _ = J.gssvx(A, b, J.Options(dtype="float32", block_size=bs))
    rt, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs),
                     device="cpu")
    # both refine an f32 factor with f64 residuals to f64 quality: the
    # solutions agree far below the 1e-10 bound (measured ~1e-15)
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    # pdgsrfs stops at berr <= eps or when berr stops halving; measured
    # at most 4e-16 for these cases
    assert rt.berr.max() < 1e-15 and rj.berr.max() < 1e-15
    # the port keeps the fused loop's stopping rule; on these seeds both
    # packages' berr trajectories cross eps at the same step
    assert rt.stat.refine_steps == rj.stat.refine_steps
    assert rt.stat.tiny_pivots == rj.stat.tiny_pivots
    assert rt.stat.counters["gemm_precision"] == "highest"
    assert np.abs(A @ rt.x - b).max() / np.abs(b).max() < 1e-12


def test_tiny_pivot_count_matches_jax():
    """Without row matching the unsymmetric fixture leans on tiny-pivot
    replacement; both packages count the same replacements."""
    A = tt.unsymmetric_pattern(120, seed=3).tocsc()
    b = np.ones(A.shape[0])
    kw = dict(dtype="float32", block_size=16)
    rj, _ = J.gssvx(A, b, J.Options(row_perm=J.RowPerm.NOROWPERM, **kw))
    rt, _ = T.gssvx(A, b, T.Options(row_perm=T.RowPerm.NOROWPERM, **kw),
                    device="cpu")
    assert rt.stat.tiny_pivots == rj.stat.tiny_pivots > 0


def test_float64_on_cpu_and_norefine():
    A = tt.laplacian_2d(10).tocsc()
    b = np.arange(A.shape[0], dtype=np.float64)
    r64, _ = T.gssvx(A, b, T.Options(dtype="float64", block_size=16),
                     device="cpu")
    assert r64.berr.max() < 1e-15
    rn, _ = T.gssvx(A, b, T.Options(dtype="float32", block_size=16,
                                    iter_refine=T.IterRefine.NOREFINE),
                    device="cpu")
    assert rn.stat.refine_steps == 0 and rn.berr.max() < 1e-5


def test_no_device_raises_without_cuda():
    A = tt.laplacian_2d(6).tocsc()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.gssvx(A, np.ones(A.shape[0]))
    with pytest.raises(RuntimeError):
        T.SparseLU(A, T.Options(), device="cuda")


#: executor cases: matrix, block size, Options, and the executor that the
#: Options select (as the JAX package selects it). In interpret mode the
#: JAX package stands etree alignment down for its fused executors unless
#: ``align_blocks="on"`` (driver.py:250-284); the port always aligns, so
#: the flk cases ask for it and both packages build the same plan.
EXEC_CASES = {
    "ilu1": (lambda: tt.laplacian_3d(8), 16,
             dict(ilu_level=1, max_refine_steps=60, refine_rthresh=1.0,
                  align_blocks="on"), "flk"),
    "flk": (lambda: tt.laplacian_3d(8), 16,
            dict(executor="flk", align_blocks="on"), "flk"),
    "pallas": (tt.laplacian_arrowhead, 128, dict(executor="pallas"),
               "pallas"),
}


@pytest.mark.parametrize("name", sorted(EXEC_CASES))
def test_gssvx_executors_match_jax(name, monkeypatch):
    """The JAX package runs its flk or Pallas level executor (interpret
    mode); both refine to f64 quality, on the same plan."""
    monkeypatch.setenv("SLU_TPU_FORCE_PALLAS", "interpret")
    make, bs, kw, exc = EXEC_CASES[name]
    A = make().tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rj, _ = J.gssvx(A, b, J.Options(dtype="float32", block_size=bs, **kw))
    rt, _ = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs, **kw),
                    device="cpu")
    assert rt.stat.counters["executor"] == exc
    assert rt.berr.max() <= 1e-12 and rj.berr.max() <= 1e-12
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    assert rt.stat.counters["fill_blocks"] == rj.stat.counters["fill_blocks"]
    assert rt.stat.tiny_pivots == rj.stat.tiny_pivots
    assert np.abs(A @ rt.x - b).max() / np.abs(b).max() < 1e-10


def test_ilu_float64_matches_jax():
    """tests/test_ilu.py's case through the port: ILU(1) and refinement
    as a preconditioned Richardson iteration, in float64."""
    A = tt.laplacian_2d(10)
    rng = np.random.default_rng(0)
    xt = rng.standard_normal(A.shape[0])
    b = A @ xt
    kw = dict(dtype="float64", block_size=8, ilu_level=1,
              row_perm=T.RowPerm.NOROWPERM, equil=T.Equil.NO,
              col_perm=T.ColPerm.NATURAL, max_refine_steps=60,
              refine_rthresh=1.0)
    lu = T.SparseLU(A, T.Options(**kw), device="cpu")
    x, _ = lu.refine(b, lu.solve(b))
    assert np.abs(x - xt).max() < 1e-8
    jkw = dict(kw, row_perm=J.RowPerm.NOROWPERM, equil=J.Equil.NO,
               col_perm=J.ColPerm.NATURAL)
    jlu = J.SparseLU(A, J.Options(**jkw))
    xj, _ = jlu.refine(b, jlu.solve(b))
    assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()


def test_ilu_state_from_jax_solves():
    """An ILU(1) factorization of the JAX package loads through
    ``from_numpy_state`` (the plan fields carry the dropped fill) and
    refines to the same solution."""
    A = tt.laplacian_3d(8).tocsc()
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    kw = dict(dtype="float32", block_size=16, ilu_level=1,
              max_refine_steps=60, refine_rthresh=1.0)
    jlu = J.SparseLU(A, J.Options(**kw))
    tlu = T.SparseLU.from_numpy_state(numpy_state(jlu, T.Options(**kw)),
                                      device="cpu")
    assert tlu.plan.nslots < J.SparseLU(A, J.Options(
        dtype="float32", block_size=16)).plan.nslots
    xt, bt = tlu.refine(b, tlu.solve(b))
    xj, bj = jlu.refine(b, jlu.solve(b))
    assert bt.max() <= 1e-12 and bj.max() <= 1e-12
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


@pytest.mark.parametrize("kw", [
    dict(dtype="complex64"), dict(gemm_precision="bf16"),
], ids=["dtype", "gemm_precision"])
def test_unported_options_raise(kw):
    """Options the port refused until they were ported now run on the
    CPU: complex64 factors and solves (the level executor, complex128
    refinement), and ``gemm_precision="bf16"`` factors clk's products in
    one bf16 pass (the plain versions' rounding) and refines to f64
    quality, in more steps than a "highest" factor."""
    A = tt.laplacian_2d(6).tocsc()
    if kw.get("dtype") == "complex64":
        b = np.arange(A.shape[0]) * (1 + 0.5j)
        res, lu = T.gssvx(A, b, T.Options(block_size=8, **kw), device="cpu")
        assert lu.pool.dtype == torch.complex64
        assert res.stat.counters["executor"] == "pallas"
        assert res.berr.max() <= 1e-15
        assert np.abs(A @ res.x - b).max() <= 1e-12 * np.abs(b).max()
        return
    A.data = A.data * (1.0 + 0.1 * np.random.default_rng(1).standard_normal(
        A.nnz))
    b = np.arange(A.shape[0]) + 1.0
    res, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=8, **kw),
                      device="cpu")
    hi, _ = T.gssvx(A, b, T.Options(dtype="float32", block_size=8),
                    device="cpu")
    assert res.stat.counters["executor"] == "clk"
    assert res.stat.counters["gemm_precision"] == "default"
    assert hi.stat.counters["gemm_precision"] == "highest"
    assert "precision_escalated" not in res.stat.counters
    assert res.berr.max() <= 1e-15
    assert np.abs(A @ res.x - b).max() <= 1e-12 * np.abs(b).max()
    assert res.stat.refine_steps > hi.stat.refine_steps


@pytest.mark.parametrize("option", ["trans", "fact", "condition_number",
                                    "executor-tck", "executor-xla"])
def test_formerly_refused_options_run(option, monkeypatch):
    """The options that the port refused before the transposed solve, the
    tck kernel and the ``"xla"`` executor were ported now run, as the JAX
    package runs them: tck against the JAX tck (interpret mode, the same
    plan), ``"xla"`` against the JAX package's level-batched XLA executor,
    which the port's level executor computes per level with kernels."""
    A = tt.unsymmetric_pattern(120, seed=4).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(dtype="float32", block_size=16)
    if option.startswith("executor-"):
        exc = option.split("-")[1]
        if exc == "tck":
            monkeypatch.setenv("SLU_TPU_FORCE_PALLAS", "interpret")
        kw.update(executor=exc, align_blocks="on")
        res, _ = T.gssvx(A, b, T.Options(**kw), device="cpu")
        rj, _ = J.gssvx(A, b, J.Options(**kw))
        assert res.stat.counters["executor"] == \
            {"tck": "tck", "xla": "pallas"}[exc]
        assert "tck_jobs" in rj.stat.counters if exc == "tck" else \
            "clk_jobs" not in rj.stat.counters
        assert res.stat.counters["fill_blocks"] == \
            rj.stat.counters["fill_blocks"]
        assert np.abs(res.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    elif option == "trans":
        res, _ = T.gssvx(A, b, T.Options(trans=T.Trans.TRANS, **kw),
                         device="cpu")
        assert np.abs(A.T @ res.x - b).max() / np.abs(b).max() < 1e-12
    elif option == "fact":
        _, lu = T.gssvx(A, b, T.Options(**kw), device="cpu")
        A2 = A.copy()
        A2.data = A.data * 1.01
        res, lu2 = T.gssvx(A2, b, T.Options(fact=T.Fact.SAME_PATTERN, **kw),
                           lu=lu)
        assert lu2 is lu
        assert np.abs(A2 @ res.x - b).max() / np.abs(b).max() < 1e-12
    else:
        res, _ = T.gssvx(A, b, T.Options(condition_number=True, **kw),
                         device="cpu")
        rj, _ = J.gssvx(A, b, J.Options(condition_number=True, **kw))
        # the estimate carries the f32 solves' rounding
        assert res.rcond == pytest.approx(rj.rcond, rel=1e-3)
    assert res.berr.max() < 1e-15


def test_float64_on_cuda_raises():
    """float64 on a ``cuda`` device raises only for an unknown executor:
    ``gemm_precision="bf16"`` resolves to "highest" there (the level
    executor has no low pass), while a float32 low pass on tck or flk
    (ROADMAP.md item 2b, ported) passes and resolves to "default". Complex
    data passes with a complex dtype (and runs the level executor); with a
    real dtype it raises, as its imaginary part would be dropped."""
    cuda, A = torch.device("cuda"), sp.eye(4).tocsc()
    o = T.Options(dtype="float64", gemm_precision="bf16")
    tdrv._check_supported(o, cuda, A)
    assert tdrv._resolve_precision(o, cuda, tdrv._executor(o)) == "highest"
    for kw in (dict(executor="tck"), dict(executor="flk"),
               dict(ilu_level=1)):
        for prec in ("bf16", "auto"):
            o = T.Options(dtype="float32", gemm_precision=prec, **kw)
            tdrv._check_supported(o, cuda, A)
            assert tdrv._resolve_precision(o, cuda, tdrv._executor(o)) \
                == "default"
    for dt in ("complex64", "complex128"):
        o = T.Options(dtype=dt)
        tdrv._check_supported(o, cuda, (A * 1j).tocsc())
        assert tdrv._executor(o) == "pallas"
    with pytest.raises(ValueError, match="complex dtype"):
        tdrv._check_supported(T.Options(dtype="float64"), cuda,
                              (A * 1j).tocsc())
    with pytest.raises(ValueError, match="unknown executor"):
        tdrv._check_supported(T.Options(dtype="float64", executor="nope"),
                              cuda, A)


def test_float64_on_cuda_runs_level_executor():
    """float64 passes ``_check_supported`` on a ``cuda`` device and,
    whatever the executor names, ILU or not, runs the level executor, as
    the JAX package runs no fused kernel but in float32 (driver.py:644-645
    there)."""
    for exc in (None, "clk", "tck", "flk", "pallas", "xla"):
        for ilu in (None, 1):
            o = T.Options(dtype="float64", executor=exc, ilu_level=ilu)
            tdrv._check_supported(o, torch.device("cuda"), sp.eye(4).tocsc())
            assert tdrv._executor(o) == "pallas"
    assert tdrv._executor(T.Options(dtype="float32", executor="xla")) \
        == "pallas"


@pytest.mark.parametrize("executor", [None, "tck"], ids=["default", "tck"])
def test_float64_gssvx_matches_jax(executor):
    """A float64 ``gssvx`` runs the level executor (recorded in the
    executor counter) and agrees with the JAX package's float64 gssvx,
    which runs its XLA executor, to 1e-12 relative."""
    A = tt.unsymmetric_pattern(150, seed=5).tocsc()
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    kw = dict(dtype="float64", block_size=16, executor=executor)
    rt, _ = T.gssvx(A, b, T.Options(**kw), device="cpu")
    rj, _ = J.gssvx(A, b, J.Options(**kw))
    assert rt.stat.counters["executor"] == "pallas"
    assert rt.berr.max() < 1e-15 and rj.berr.max() < 1e-15
    assert rt.stat.tiny_pivots == rj.stat.tiny_pivots
    assert np.abs(rt.x - rj.x).max() <= 1e-12 * np.abs(rj.x).max()


@pytest.mark.parametrize("dtype,executor", [("float32", "xla"),
                                            ("float32", "clk"),
                                            ("float64", None)])
def test_profile_levels(dtype, executor):
    """``profile_levels`` (tests/test_factor.py:260-270,
    tests/test_round4_fixes.py:29-43): one row per factor level, whose
    steps/lpanels/upanels/gemms equal the JAX package's profile on the
    same plan; the factors are reinstalled, so the solve after the
    profile equals the one before (to the float32 factor's rounding when
    the live factor came from clk)."""
    from superlu_dist_tpu.ops.kernels import blocklu as jbl
    A = tt.laplacian_2d(10).tocsc()
    lu = T.SparseLU(A, T.Options(dtype=dtype, block_size=8,
                                 executor=executor), device="cpu")
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    x_before = lu.solve(b)
    rows = lu.profile_levels()
    assert len(rows) == lu.plan.n_flevels
    assert lu.stat.counters["profiled_levels"] == len(rows)
    assert all(r["ms"] >= 0 and r["gflops_model"] >= 0 for r in rows)
    jrows, _ = jbl.profile_factor_levels(lu.plan, lu._a3_data, np.float64,
                                         lu._thresh(), chunk=16)
    keys = ("level", "steps", "lpanels", "upanels", "gemms")
    assert [{k: r[k] for k in keys} for r in rows] == \
        [{k: r[k] for k in keys} for r in jrows]
    assert sum(r["steps"] for r in rows) == lu.plan.nb
    assert sum(r["gemms"] for r in rows) == len(lu.plan.g_l)
    x_after = lu.solve(b)
    tol = 1e-12 if dtype == "float64" else 1e-4
    assert np.abs(x_after - x_before).max() <= tol * np.abs(x_before).max()
    x, berr = lu.refine(b, x_after)
    assert berr.max() < 1e-15


def test_profile_levels_after_load_factors_raises(tmp_path):
    """A ``load_factors`` instance carries no factor input values: the
    profile raises (tests/test_round4_fixes.py:46-55) and the instance
    still solves."""
    A = tt.laplacian_2d(6).tocsc()
    lu = T.SparseLU(A, T.Options(dtype="float64", block_size=8),
                    device="cpu")
    path = tmp_path / "f.npz"
    T.save_factors(lu, path)
    lu2 = T.load_factors(path, device="cpu")
    with pytest.raises(RuntimeError, match="input"):
        lu2.profile_levels()
    b = np.asarray(A @ np.ones(A.shape[0]))
    assert np.abs(A @ lu2.solve(b) - b).max() < 1e-10


def test_unknown_executor_raises():
    A = tt.laplacian_2d(6).tocsc()
    with pytest.raises(ValueError, match="unknown executor"):
        T.SparseLU(A, T.Options(block_size=8, executor="cpu"), device="cpu")
