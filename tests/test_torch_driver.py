"""The port's ``gssvx`` on the CPU (plain versions of the kernels)
against the JAX package's ``gssvx`` on the CPU, end to end: solution,
backward error, refinement steps and tiny-pivot count; and the port's
refusals (no silent CPU fallback, unported options raise)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import superlu_dist_tpu as J

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.models import driver as tdrv
from superlu_dist_tpu_torch.utils import testing as tt

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


@pytest.mark.parametrize("kw", [
    dict(dtype="complex64"), dict(ilu_level=1), dict(executor="flk"),
    dict(trans=T.Trans.TRANS), dict(fact=T.Fact.SAME_PATTERN),
    dict(condition_number=True), dict(gemm_precision="bf16"),
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kw):
    A = tt.laplacian_2d(6).tocsc()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.SparseLU(A, T.Options(block_size=8, **kw), device="cpu")


def test_float64_on_cuda_raises():
    with pytest.raises(NotImplementedError, match="float64 on CUDA"):
        tdrv._check_supported(T.Options(dtype="float64"),
                              torch.device("cuda"), sp.eye(4).tocsc())
