"""superlu_dist_tpu_torch: the PyTorch/CUDA port of superlu_dist_tpu.

Sparse direct solver for one NVIDIA Hopper GPU::

    import scipy.sparse as sp
    from superlu_dist_tpu_torch import gssvx, Options
    res, lu = gssvx(A, b, Options(dtype="float32"))   # on "cuda"
    res.x, res.berr

The host preprocessing (equilibration, MC64, ordering, etree alignment,
block symbolic) is a copy of the JAX package's; the factor and the
triangular sweeps run hand-written CUDA kernels (``ops/kernels/csrc``).
Pass ``device="cpu"`` to run the plain PyTorch version of every kernel.
This package imports neither JAX nor ``superlu_dist_tpu``.
"""

from .models.driver import SolveResult, SparseLU, gssvx
from .utils.options import (ColPerm, DiagScale, Equil, Fact, IterRefine,
                            Options, RowPerm, Trans)
from .utils.stats import Stats

__all__ = ["gssvx", "SparseLU", "SolveResult", "Options", "Stats", "Fact",
           "RowPerm", "ColPerm", "Trans", "IterRefine", "Equil",
           "DiagScale"]
