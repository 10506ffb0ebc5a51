"""Build-cache pre-warming (the deployment answer to first-call cost).

The reference pays no build cost (pdgstrf.c is compiled ahead of time).
The port builds its hand-written CUDA kernels with ``nvcc`` on first use
into ``build/torch_kernels/`` (one library per source, keyed by a hash of
the source, its shared headers and the flags), and its native host engine
with ``g++`` into ``build/torch_native/``; a process that finds a library
there loads it instead of building it. The first factor of a process also
pays its first CUDA launches. :func:`prewarm` pays all of that once per
checkout, before serving: every later process (batch jobs, serving
replicas) loads the libraries and starts factoring at once.

Usage — warm once per deployment (offline, any process)::

    from superlu_dist_tpu_torch.utils.prewarm import prewarm
    prewarm(A_representative, Options(dtype="float32"))

or from the shell, which prints the returned dict as one JSON line::

    python -m superlu_dist_tpu_torch.utils.prewarm path/to/matrix.rua
"""

from __future__ import annotations

import json
import time

import numpy as np


def prewarm(A, options=None, *, nrhs=(1,), refine: bool = True,
            device=None) -> dict:
    """Build every kernel library of the port, then factor, solve (and
    refine) ``A`` once on ``device`` (default ``cuda``; ``"cpu"`` builds
    only the native host engine, as no kernel runs there).

    When the factor ran bf16-first (``gemm_precision="auto"`` with
    refinement, on the card), the ``"highest"`` re-factor that a
    refinement stall escalates to is run once too
    (``escalation_warm_s``), so an escalation in service pays no first
    call of the FP32 entries either.

    Returns ``n``, ``build_s`` (the build or load of every library),
    ``factor_s``, ``solve_s``, ``escalation_warm_s`` (0 where no
    escalation can run), and the plan's ``nb`` and ``nslots``. The
    factorization object is discarded."""
    from ..models.driver import SparseLU, _resolve_device
    from ..ops.host.native import get_lib
    from ..ops.kernels import _build, cuda_kernels
    from .options import Options
    options = options or Options()
    dev = _resolve_device(device)
    t0 = time.perf_counter()
    get_lib()
    if dev.type == "cuda":
        _build.build_all(list(cuda_kernels().values()))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    lu = SparseLU(A, options, device=dev)
    t_factor = time.perf_counter() - t0
    n = lu.n
    rng = np.random.default_rng(0)
    b = np.asarray(A @ rng.standard_normal(n)).real.astype(
        np.result_type(lu.dtype, np.float32))
    if np.dtype(lu.dtype).kind == "c":
        b = b.astype(lu.dtype)
    t0 = time.perf_counter()
    for k in nrhs:
        bk = b if k == 1 else np.tile(b[:, None], (1, k))
        x = lu.solve(bk)
        if refine:
            lu.refine(bk, x)
    t_solve = time.perf_counter() - t0
    # "auto" factors bf16-first; a refinement stall in service re-factors
    # at "highest": run that variant once too
    t_esc = 0.0
    if lu._gemm_prec_used == "default" and lu._escalate_ok:
        t0 = time.perf_counter()
        lu._refactor_values("highest")
        t_esc = time.perf_counter() - t0
    return dict(n=n, build_s=t_build, factor_s=t_factor, solve_s=t_solve,
                escalation_warm_s=t_esc, nb=int(lu.plan.nb),
                nslots=int(lu.plan.nslots))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrix", help="matrix file (HB/RB/MM/triple/binary)")
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from .io import read_matrix
    from .options import Options
    A = read_matrix(args.matrix)
    kw = {}
    if args.block_size:
        kw["block_size"] = args.block_size
    if args.dtype:
        kw["dtype"] = args.dtype
    info = prewarm(A, Options(**kw), device=args.device)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
