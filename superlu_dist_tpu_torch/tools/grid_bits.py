"""Bit-for-bit A/B of the 2D grid's solutions between two checkouts.

    python superlu_dist_tpu_torch/tools/grid_bits.py --root A a.npz
    python superlu_dist_tpu_torch/tools/grid_bits.py --root B b.npz
    python superlu_dist_tpu_torch/tools/grid_bits.py --compare a.npz b.npz

The first two forms import ``superlu_dist_tpu_torch`` from the checkout
``--root`` (which builds its own kernels there) and run ``gssvx_dist`` on
a 2x2 grid on the card at block size 128: lap3d32 in float32 and
float64, helmholtz_3d(32) in complex64 and complex128 (each with one
seeded right-hand side), and TRANS with the condition estimate on
lap3d32u in float32; they save every x and rcond to the ``.npz``. The
third form prints, per case, whether the two files' arrays are
bit-equal, and exits 1 unless all are. Run both checkouts in one call on
one card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def run(root: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from superlu_dist_tpu_torch import Grid2D, Options, Trans, gssvx_dist
    from superlu_dist_tpu_torch.utils.testing import (helmholtz_3d,
                                                      laplacian_3d,
                                                      laplacian_3d_unsym)
    cases = {"float32": (laplacian_3d, {}),
             "float64": (laplacian_3d, {}),
             "complex64": (helmholtz_3d, {}),
             "complex128": (helmholtz_3d, {}),
             "float32_trans": (laplacian_3d_unsym,
                               dict(trans=Trans.TRANS,
                                    condition_number=True))}
    got = {}
    for name, (make, kw) in cases.items():
        dtype = name.split("_")[0]
        A = make(32).tocsc()
        rng = np.random.default_rng(7)
        b = rng.standard_normal(A.shape[0])
        if dtype.startswith("complex"):
            b = b + 1j * rng.standard_normal(A.shape[0])
        res, _ = gssvx_dist(A, b, Grid2D(2, 2), Options(
            dtype=dtype, block_size=128, **kw))
        got[f"{name}_x"] = res.x
        if res.rcond is not None:
            got[f"{name}_rcond"] = np.asarray(res.rcond)
        print(f"{root}: {name} berr {np.max(res.berr):.3e}, "
              f"{res.stat.refine_steps} refinement steps", flush=True)
    np.savez(out, **got)


def compare(a: str, b: str) -> int:
    x, y = np.load(a), np.load(b)
    same = {k: bool(k in y.files and np.array_equal(x[k], y[k]))
            for k in x.files}
    same.update({k: False for k in y.files if k not in x.files})
    for k, v in same.items():
        print(f"{k}: bit-equal {v}")
    return 0 if all(same.values()) else 1


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", help="the checkout to import the port from")
    p.add_argument("--compare", nargs=2, metavar="NPZ")
    p.add_argument("out", nargs="?")
    a = p.parse_args()
    if a.compare:
        sys.exit(compare(*a.compare))
    if not (a.root and a.out):
        p.error("give --root and an output file, or --compare")
    run(a.root, a.out)


if __name__ == "__main__":
    main()
