"""Compare the main path's phase times of two checkouts on one card.

    python superlu_dist_tpu_torch/tools/phases_ab.py ROOT_A ROOT_B [PAIRS]

Each ROOT is the root of a checkout (``superlu_dist_tpu_torch`` below
it). The checkouts run in turns A, B, B, A, ... for PAIRS pairs (4 unless
given), each turn in a process of its own that imports the package from
its ROOT and makes ``CALLS`` warm calls after one cold call of:

- the main path, ``gssvx(A, b, Options(dtype="float32",
  block_size=128))`` on ``laplacian_3d(32)``: FACT, SOLVE and REFINE;
- the transposed solve, ``Options(..., trans=Trans.TRANS)`` on
  ``laplacian_3d_unsym(32)``: its SOLVE, which ``solve_gemm.cu``'s two
  passes run;
- the 2D grid, ``gssvx_dist(A, b, Grid2D(2, 2), Options(dtype="float32",
  block_size=128))`` on ``laplacian_3d(32)``: its FACT and SOLVE, which
  ``rdma.cu`` runs.

Device ms per phase are the driver's CUDA-event phases (``Stats``). It
prints the card and, per checkout and phase, the median, the quartiles
and every call's ms. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CALLS = 5
PHASES = (("main", "FACT"), ("main", "SOLVE"), ("main", "REFINE"),
          ("trans", "SOLVE"), ("grid", "FACT"), ("grid", "SOLVE"))

_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from superlu_dist_tpu_torch import Grid2D, Options, Trans, gssvx, gssvx_dist
from superlu_dist_tpu_torch.utils.testing import (laplacian_3d,
                                                  laplacian_3d_unsym)
out = {}
for what, A, opts in (
        ("main", laplacian_3d(32), Options(dtype="float32",
                                           block_size=128)),
        ("trans", laplacian_3d_unsym(32),
         Options(dtype="float32", block_size=128, trans=Trans.TRANS)),
        ("grid", laplacian_3d(32), Options(dtype="float32",
                                           block_size=128))):
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    runs = []
    for i in range(int(sys.argv[2]) + 1):
        res, _ = (gssvx_dist(A, b, Grid2D(2, 2), opts) if what == "grid"
                  else gssvx(A, b, opts))
        if i:
            runs.append(dict(res.stat.device_ms))
    out[what] = runs
print(json.dumps(out))
"""


def _quartiles(v):
    v = sorted(v)
    n = len(v)
    return v[n // 4], v[n // 2], v[(3 * n) // 4]


def main(roots, pairs: int) -> None:
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    order = []
    for p in range(pairs):
        order += [0, 1] if p % 2 == 0 else [1, 0]
    ms = {i: {k: [] for k in PHASES} for i in (0, 1)}
    for i in order:
        root = os.path.abspath(roots[i])
        out = subprocess.run([sys.executable, "-c", _CHILD, root,
                              str(CALLS)], capture_output=True, text=True,
                             cwd=root)
        if out.returncode != 0:
            raise SystemExit(f"{root}: {out.stderr[-2000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        for what, phase in PHASES:
            ms[i][(what, phase)] += [r[phase] for r in got[what]]
    for what, phase in PHASES:
        for i in (0, 1):
            q1, med, q3 = _quartiles(ms[i][(what, phase)])
            print(f"{what} {phase} {roots[i]}: median {med:.3f} ms "
                  f"(quartiles {q1:.3f}-{q3:.3f}) over "
                  f"{len(ms[i][(what, phase)])} warm calls: "
                  + " ".join(f"{v:.3f}" for v in ms[i][(what, phase)]),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:3], int(sys.argv[3]) if len(sys.argv) > 3 else 4)
