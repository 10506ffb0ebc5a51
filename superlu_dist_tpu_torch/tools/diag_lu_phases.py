"""Where ``diag_lu.cu``'s time goes, phase by phase, on one card.

    python -m superlu_dist_tpu_torch.tools.diag_lu_phases

Builds three libraries from the checkout's ``diag_lu.cu`` and
``tile_lu.cuh`` (their sources under ``build/torch_kernels/phases``): the
kernel as it is, a copy whose ``tile_lu`` returns once the forward LU is done (the tile
factored, the tiny count added), and one that returns just before the
L⁻¹ / U⁻¹ sweeps (the LU stored, the factor columns staged). For float32
and float64 at 8 tiles of 128 × 128 and of 64 × 64 it launches the three
in turn (an L2 flush before each launch, CUDA events around it) and
prints the median ms of each and the differences: the forward LU, the
sweeps' set-up, and the sweeps with the stores of both inverses. The
launch itself (its host call, the tile's load) stays in the first.
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

from ..ops.kernels import _build
from . import diag_lu_ab

REPS = 60
#: where each variant returns: the line after which ``return;`` goes
CUTS = {
    "forward": "  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);\n",
    "setup": "  T* Z = A;\n",
}


def _variant(name: str):
    src = _build._CSRC
    out = os.path.join(_build.BUILD_DIR, "phases", name)
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(src, "diag_lu.cu"), out)
    with open(os.path.join(src, "tile_lu.cuh")) as f:
        text = f.read()
    if name in CUTS:
        key = CUTS[name]
        if text.count(key) != 1:
            raise SystemExit(f"diag_lu_phases: no single anchor for {name}")
        text = text.replace(key, key + "  return;\n")
    with open(os.path.join(out, "tile_lu.cuh"), "w") as f:
        f.write(text)
    return diag_lu_ab._build_lib(os.path.join(out, "diag_lu.cu"),
                                 f"phase_{name}")[0]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("diag_lu_phases needs a CUDA device")
    libs = {k: _variant(k) for k in ("full", "forward", "setup")}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ntile = 8
    for bs in (128, 64):
        for dt, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
            base, slots, steps = diag_lu_ab.tiles(bs, dt, ntile)
            ms = {k: [] for k in libs}
            for rep in range(REPS + 1):
                for name, lib in libs.items():
                    t, _ = diag_lu_ab.timed_launch(
                        getattr(lib, f"slu_diag_lu_{sfx}"), base, slots,
                        steps, flush, stream)
                    if rep:       # the first round warms all three up
                        ms[name].append(t)
            m = {k: float(np.median(v)) for k, v in ms.items()}
            print(f"diag_lu {sfx} bs {bs}, {ntile} tiles (median ms): "
                  f"whole {m['full']:.4f}; up to the end of the forward LU "
                  f"{m['forward']:.4f}, to the sweeps {m['setup']:.4f}; "
                  f"sweep set-up {m['setup'] - m['forward']:.4f}, sweeps "
                  f"and stores {m['full'] - m['setup']:.4f} "
                  f"({(m['full'] - m['setup']) / m['full']:.0%} of the "
                  "whole)", flush=True)


if __name__ == "__main__":
    main()
