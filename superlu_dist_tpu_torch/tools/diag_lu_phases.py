"""Where ``diag_lu.cu``'s time goes, phase by phase, on one card.

    python -m superlu_dist_tpu_torch.tools.diag_lu_phases [--stamps [--warm]] [CSRC ...]

For each ``CSRC`` (a directory holding ``diag_lu.cu`` and the headers it
includes; by default the checkout's ``csrc``) builds the kernel as it is
and one copy per cut, each of whose ``tile_lu`` returns at the cut
(sources under ``build/torch_kernels/phases``). The cuts are the lines
of :data:`CUTS` that the source's ``tile_lu.cuh`` holds exactly once, in
the kernel's order: ``forward`` (the tile factored, the tiny count
added), ``stores`` (the LU and each panel's diagonal inverses stored,
before the block substitution's stages) and, in a source of the kernel
that built its inverses by two sweeps, ``setup`` (the sweeps' packed
square set up). For float32 and float64 at 8 tiles of 128 × 128, 64 ×
64 and 32 × 32 it launches every build in turn (an L2 flush before each
launch, CUDA events around it) and prints the median ms of each and the
differences, the first phase with the launch itself (its host call, the
tile's load) inside. With ``--stamps`` it builds instead one copy
that reads the SM's clock (``clock64``) in CTA 0's thread 0 at each line
of :data:`STAMPS` the source holds, and prints the median cycles between
them over the launches: per panel the subtile LU (warp 0), the subtile
inverses (to the barrier after them), the L and U blocks and the
trailing update; then the stores and each distance of the block
substitution; with ``--warm`` there is no L2 flush between the launches
(the kernel's code stays in L2). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import sys

import numpy as np

from ..ops.kernels import _build
from . import diag_lu_ab

REPS = 60
#: where each cut returns: the line after which ``return;`` goes
CUTS = {
    "forward": "  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);\n",
    "stores": "  // (e) the block substitution, stage by stage\n",
    "setup": "  T* Z = kSh ? A : gl;\n",
}
#: where ``--stamps`` reads the clock: (line, what ends there, slot); a
#: line inside ``panels`` stamps slot + 4 × its panel, a stage's slot + its
#: distance
STAMPS = [
    ("  const int tid = threadIdx.x;\n", "entry", 0),
    ("  panels<T, BS, 0>(A, S, LI, UI, thresh, ntiny);\n", "tile loaded", 1),
    ("    ntiny += subtile_lu<T>(A + O * BS + O, BS, S, thresh);\n",
     "subtile LU", 2),
    ("  __syncthreads();\n  if constexpr (O + kPb < BS) {\n",
     "subtile inverses", 3),
    ("    panel_blocks<T, BS, O>(A, li, ui);\n", "L and U blocks", 4),
    ("    trailing<T, BS, O>(A);\n", "trailing update", 5),
    ("  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);\n", "forward LU end",
     20),
    ("  if constexpr (P > 1) __syncthreads();\n", "stores", 21),
    ("    if (d + 1 < P) __syncthreads();\n", "distance", 21),
]
NSTAMP = 32
#: what the time from the cut before to each cut (or to the end) holds
PHASES = {
    "forward": "forward LU",
    "stores": "LU and diagonal inverses stored",
    "setup": "sweep set-up",
}
END_AFTER = {"stores": "block stages", "setup": "sweeps and stores"}


def cuts_in(text: str) -> list:
    """The names of the cuts whose line occurs once in ``text``, in the
    source's order; raises if one occurs more than once."""
    found = []
    for name, line in CUTS.items():
        n = text.count(line)
        if n > 1:
            raise SystemExit(f"diag_lu_phases: {n} anchors for {name}")
        if n == 1:
            found.append((text.index(line), name))
    return [name for _, name in sorted(found)]


def _copy(csrc: str, tag: str):
    """``diag_lu.cu`` and the headers of ``csrc`` copied under
    ``build/torch_kernels/phases/tag``: that directory and the copy's
    ``tile_lu.cuh``."""
    out = os.path.join(_build.BUILD_DIR, "phases", tag)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(csrc):
        if f == "diag_lu.cu" or f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), out)
    with open(os.path.join(out, "tile_lu.cuh")) as f:
        return out, f.read()


def _variant(csrc: str, tag: str, cut=None):
    out, text = _copy(csrc, tag)
    if cut is not None:
        key = CUTS[cut]
        text = text.replace(key, key + "  return;\n")
    with open(os.path.join(out, "tile_lu.cuh"), "w") as f:
        f.write(text)
    return diag_lu_ab._build_lib(os.path.join(out, "diag_lu.cu"),
                                 f"phase_{tag}")[0]


def _stamped(csrc: str, tag: str):
    """A copy of ``csrc`` whose CTA 0, thread 0 writes ``clock64()`` into
    ``slu_stamp[slot]`` at each line of :data:`STAMPS` it holds (after it,
    or before it for a call that starts a phase), with an entry
    ``slu_read_stamps`` that copies them out; and the slots' names."""
    out, text = _copy(csrc, tag)

    def stamp(k):
        return ("if (threadIdx.x == 0 && blockIdx.x == 0) "
                f"slu_stamp[{k}] = clock64();")

    names = {}
    # the end: every warp done
    end = "    if (d + 1 < P) __syncthreads();\n  }\n}\n"
    if text.count(end) == 1:
        text = text.replace(end, end[:-2] + "  __syncthreads();\n  " +
                            stamp(NSTAMP - 1) + "\n}\n")
        names[NSTAMP - 1] = "end"
    for line, what, slot in STAMPS:
        if text.count(line) != 1:
            continue
        k = slot
        if slot in (2, 3, 4, 5):       # per panel
            k = f"{slot} + 4 * (O / kPb)"
            for p in range(4):
                names[slot + 4 * p] = f"panel {p}: {what}"
        elif what == "distance":
            k = f"{slot} + d"
            for d in range(1, 4):
                names[slot + d] = f"distance {d}"
        else:
            names[slot] = what
        if what == "tile loaded":
            new = "  " + stamp(k) + "\n" + line
        elif what == "subtile LU":
            new = "    {" + line.strip() + " " + stamp(k) + "}\n"
        elif what == "subtile inverses":     # after the barrier
            first, second = line.split("\n")[:2]
            new = first + "\n  " + stamp(k) + "\n" + second + "\n"
        else:
            new = line + "  " + stamp(k) + "\n"
        text = text.replace(line, new)
    text = text.replace("namespace slu_tile {\n",
                        "namespace slu_tile {\n__device__ long long "
                        f"slu_stamp[{NSTAMP}];\n", 1)
    with open(os.path.join(out, "tile_lu.cuh"), "w") as f:
        f.write(text)
    with open(os.path.join(out, "diag_lu.cu"), "a") as f:
        f.write("\n// copies the stamps out and clears them\n"
                "extern \"C\" int slu_read_stamps(void* out) {\n"
                f"  static const long long zero[{NSTAMP}] = {{0}};\n"
                "  cudaError_t e = cudaMemcpyFromSymbol(out, "
                "slu_tile::slu_stamp, sizeof zero);\n"
                "  if (e == cudaSuccess)\n"
                "    e = cudaMemcpyToSymbol(slu_tile::slu_stamp, zero, "
                "sizeof zero);\n"
                "  return (int)e;\n}\n")
    lib = diag_lu_ab._build_lib(os.path.join(out, "diag_lu.cu"),
                                f"stamps_{tag}")[0]
    return lib, names


def stamps(csrc: str, tag: str, flush, stream, warm=False) -> None:
    import torch
    lib, names = _stamped(csrc, tag)
    slots = sorted(names)
    if warm:
        flush = torch.empty(1, dtype=torch.uint8, device="cuda")
    print(f"{csrc}: clock stamps of CTA 0 (median cycles since the stamp "
          f"before; {'no' if warm else 'an'} L2 flush before each launch)",
          flush=True)
    for bs in (128, 64, 32):
        for sfx in ("f32", "f64"):
            base, sl, st = diag_lu_ab.tiles(bs, sfx, 8)
            runs = []
            for rep in range(REPS + 1):
                buf = (ctypes.c_longlong * NSTAMP)()
                torch.cuda.synchronize()
                diag_lu_ab.timed_launch(getattr(lib, f"slu_diag_lu_{sfx}"),
                                        base, sl, st, flush, stream)
                if lib.slu_read_stamps(buf):
                    raise RuntimeError("slu_read_stamps failed")
                if rep:
                    runs.append(list(buf))
            a = np.array(runs, dtype=np.float64)
            got = [k for k in slots if (a[:, k] != 0).all()]
            d = np.median(np.diff(a[:, got], axis=1), axis=0)
            total = float(np.median(a[:, got[-1]] - a[:, got[0]]))
            print(f"diag_lu {sfx} bs {bs}: {total:.0f} cycles from "
                  f"{names[got[0]]}; " + "; ".join(
                      f"{names[k]} {c:.0f}" for k, c in zip(got[1:], d)),
                  flush=True)


def split(csrc: str, tag: str, flush, stream) -> None:
    with open(os.path.join(csrc, "tile_lu.cuh")) as f:
        text = f.read()
    cuts = cuts_in(text)
    if not cuts or cuts[0] != "forward":
        raise SystemExit(f"diag_lu_phases: no forward cut in {csrc}")
    libs = {c: _variant(csrc, f"{tag}_{c}", c) for c in cuts}
    libs["end"] = _variant(csrc, f"{tag}_end")
    labels = [PHASES[c] for c in cuts] + [END_AFTER.get(cuts[-1],
                                                        "inverses")]
    ntile = 8
    print(f"{csrc}: cuts {', '.join(cuts)}", flush=True)
    for bs in (128, 64, 32):
        for sfx in ("f32", "f64"):
            base, slots, steps = diag_lu_ab.tiles(bs, sfx, ntile)
            ms = {k: [] for k in libs}
            for rep in range(REPS + 1):
                for name, lib in libs.items():
                    t, _ = diag_lu_ab.timed_launch(
                        getattr(lib, f"slu_diag_lu_{sfx}"), base, slots,
                        steps, flush, stream)
                    if rep:       # the first round warms every build up
                        ms[name].append(t)
            m = [float(np.median(ms[k])) for k in libs]
            parts = [m[0]] + [b - a for a, b in zip(m, m[1:])]
            print(f"diag_lu {sfx} bs {bs}, {ntile} tiles (median ms): "
                  f"whole {m[-1]:.4f} = " + " + ".join(
                      f"{lab} {p:.4f} ({p / m[-1]:.0%})"
                      for lab, p in zip(labels, parts)), flush=True)


def main(argv) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("diag_lu_phases needs a CUDA device")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    run = split
    if argv and argv[0] == "--stamps":
        run, argv = stamps, argv[1:]
        if argv and argv[0] == "--warm":
            run, argv = functools.partial(stamps, warm=True), argv[1:]
    for i, csrc in enumerate(argv or [_build._CSRC]):
        run(os.path.abspath(csrc), f"src{i}", flush, stream)


if __name__ == "__main__":
    main(sys.argv[1:])
