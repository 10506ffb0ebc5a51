"""Kernel 1 (diag_lu): the plain tile LU with inverses against the JAX
package's in-kernel tile LU (``flk._lu_tile_blocked``) and its XLA
``blocklu.block_lu_inv``, in float32 and float64, with injected tiny
pivots (positive, negative and exactly zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import flk

from superlu_dist_tpu_torch.ops.kernels import diag_lu as dl

torch.set_num_threads(2)

THRESH = 1e-3
#: well-conditioned tiles: 64 ulp of the dtype at the output's magnitude
#: (the JAX tiles eliminate in 32-wide panels or by recursive halving,
#: the plain version column by column; measured below 5 ulp).
ULPS = 64
#: the tile with replaced pivots has entries of ~1/thresh and inverses of
#: ~1/thresh², so roundoff of either elimination order is amplified by
#: ~1e6: it is compared in float64 only, at 1e-9 relative (measured
#: 3.6e-12 against the recursive XLA version).
TINY_RTOL64 = 1e-9


def tiles(m, dtype, nbat=3, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((nbat, m, m)) + m * np.eye(m)
    # tiny pivots in tile 1: zero the coupling above/left so the pivot
    # stays tiny through elimination
    for j, v in ((5, 1e-9), (9, -1e-9), (12, 0.0)):
        T[1, j, :j] = 0.0
        T[1, :j, j] = 0.0
        T[1, j, j] = v
    return T.astype(dtype)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, np.abs(b).max())
    assert np.abs(a - b).max() <= rtol * scale, \
        (np.abs(a - b).max(), rtol * scale)


_REFS = {
    "flk_blocked": jax.jit(jax.vmap(flk._lu_tile_blocked, in_axes=(0, None))),
    "block_lu_inv": jax.jit(jax.vmap(jbl.block_lu_inv, in_axes=(0, None))),
}


@pytest.mark.parametrize("ref", sorted(_REFS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [16, 64])
def test_plain_matches_jax_tile_lu(m, dtype, ref, monkeypatch):
    # the JAX tile LU's loop form, as its interpret-mode tests trace it
    # (the unrolled form compiles for a minute on the CPU; same math)
    monkeypatch.setenv("SLU_TPU_FORCE_PALLAS", "interpret")
    T = tiles(m, dtype)
    LU, li, ui, nt = dl.lu_inv_plain(torch.from_numpy(T), THRESH)
    r = [np.asarray(x) for x in
         _REFS[ref](jnp.asarray(T), jnp.asarray(THRESH, dtype=dtype))]
    # tiny-pivot counts: 3 in tile 1, none elsewhere, in both packages
    assert int(nt) == int(np.asarray(r[3]).sum()) == 3
    assert [int(np.asarray(t).sum()) for t in r[3]] == [0, 3, 0]
    for b in range(T.shape[0]):
        rtol = ULPS * np.finfo(dtype).eps if b != 1 else \
            (TINY_RTOL64 if dtype == np.float64 else None)
        if rtol is None:
            continue
        for got, want in ((LU, r[0]), (li, r[1]), (ui, r[2])):
            _close(got[b].numpy(), want[b], rtol)


def test_tiny_pivot_sign():
    """|p| < thresh becomes sign(p)·thresh, and +thresh at exactly 0."""
    T = tiles(16, np.float64)
    LU, _, _, _ = dl.lu_inv_plain(torch.from_numpy(T), THRESH)
    assert LU[1, 5, 5] == THRESH
    assert LU[1, 9, 9] == -THRESH
    assert LU[1, 12, 12] == THRESH


def test_wrapper_writes_slots_and_steps():
    """The CPU wrapper factors pool[slots] in place and files the
    inverses under their elimination steps."""
    T = torch.from_numpy(tiles(16, np.float32))
    pool = torch.cat([torch.zeros(1, 16, 16), T, torch.zeros(2, 16, 16)])
    linv = torch.zeros(5, 16, 16)
    uinv = torch.zeros(5, 16, 16)
    tiny = torch.zeros(1, dtype=torch.int32)
    slots = torch.tensor([1, 2, 3], dtype=torch.int32)
    steps = torch.tensor([4, 0, 2], dtype=torch.int32)
    dl.diag_lu(pool, linv, uinv, slots, steps, THRESH, tiny)
    LU, li, ui, nt = dl.lu_inv_plain(T, THRESH)
    assert torch.equal(pool[1:4], LU) and torch.equal(linv[steps.long()], li)
    assert torch.equal(uinv[steps.long()], ui)
    assert int(tiny) == 3 and not pool[0].any() and not linv[1].any()


def test_cuda_wrapper_refuses_cpu_shapes():
    """The CUDA path checks its inputs before any launch."""
    with pytest.raises(ValueError):
        dl._check_cuda(torch.zeros(2, 16, 16), torch.zeros(1, 16, 16),
                       torch.zeros(1, 16, 16),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), 16)


def test_phase_tool_cuts_the_kernel():
    """``tools/diag_lu_phases.py`` cuts the checkout's ``tile_lu.cuh`` at
    each line of its ``CUTS`` that the block-substitution kernel has, each
    occurring exactly once, in the kernel's order; the sweeps' cut of the
    kernel before it occurs nowhere; and each line it stamps occurs
    exactly once."""
    import os
    from superlu_dist_tpu_torch.ops.kernels import _build
    from superlu_dist_tpu_torch.tools import diag_lu_phases as ph
    with open(os.path.join(_build._CSRC, "tile_lu.cuh")) as f:
        text = f.read()
    for name in ("forward", "stores"):
        assert text.count(ph.CUTS[name]) == 1, name
    assert text.count(ph.CUTS["setup"]) == 0
    assert ph.cuts_in(text) == ["forward", "stores"]
    for line, _, _ in ph.STAMPS:
        assert text.count(line) == 1, line
