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
The 2D distributed driver runs every rank of a process grid on one
card::

    from superlu_dist_tpu_torch import Grid2D, gssvx_dist
    res, lu = gssvx_dist(A, b, Grid2D(2, 2), Options(dtype="float32"))

and the 3D communication-avoiding driver every rank of a Pz × Pr × Pc
grid::

    from superlu_dist_tpu_torch import Grid3D, gssvx3d
    res, lu = gssvx3d(A, b, Grid3D(2, 2, 2), Options(dtype="float32"))

Many systems at once: :class:`BatchedSparseLU` factors and solves N
matrices of one pattern together, one launch per level per phase for all
of them; :func:`gssvx_batch` solves heterogeneous ones through a
block-diagonal composite::

    from superlu_dist_tpu_torch import BatchedSparseLU, gssvx_batch
    blu = BatchedSparseLU(As, Options(dtype="float32"))
    X, berr = blu.refine(Bs, blu.solve(Bs))
    results, lu = gssvx_batch(As, bs, Options(dtype="float32"))

Row-distributed input (``NRLocMatrix``, the ``NRformat_loc`` analog)
goes to every driver; a grid's ranks may be split over several processes
on the one card (``parallel/multihost.py``)::

    from superlu_dist_tpu_torch.parallel import multihost
    multihost.initialize("127.0.0.1:29500", num_processes=2, process_id=pid)
    res, lu = gssvx_dist(NRLocMatrix([(lo, A_rows)], n, local=True), b,
                         Grid2D(2, 2), Options(dtype="float32"))

This package imports neither JAX nor ``superlu_dist_tpu``.
"""

from .models.batch import BatchedSparseLU, gssvx_batch
from .models.dist_driver import DistributedSparseLU, gssvx_dist
from .models.driver3d import Distributed3DSparseLU, gssvx3d
from .models.driver import (SolveResult, SparseLU, gssvx, load_factors,
                            save_factors)
from .parallel.grid import Grid2D, Grid3D
from .utils.options import (ColPerm, DiagScale, Equil, Fact, IterRefine,
                            Options, RowPerm, Trans, print_options,
                            set_default_options, sp_ienv)
from .utils.nrloc import NRLocMatrix
from .utils.stats import Stats
from .version import __version__, get_version_number

__all__ = ["gssvx", "SparseLU", "SolveResult", "save_factors",
           "load_factors", "NRLocMatrix", "gssvx_dist", "DistributedSparseLU", "Grid2D",
           "gssvx3d", "Distributed3DSparseLU", "Grid3D",
           "BatchedSparseLU", "gssvx_batch",
           "Options", "Stats", "Fact",
           "RowPerm", "ColPerm", "Trans", "IterRefine", "Equil",
           "DiagScale", "set_default_options", "sp_ienv", "print_options",
           "__version__", "get_version_number"]
