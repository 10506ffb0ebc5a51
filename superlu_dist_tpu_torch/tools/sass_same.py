"""Whether two checkouts' CUDA sources compile to the same machine code.

    python -m superlu_dist_tpu_torch.tools.sass_same [--fp32] OLD_CSRC NEW_CSRC [SOURCE ...]

Builds each ``SOURCE`` (by default every ``*.cu`` of ``NEW_CSRC``) from
both directories with the port's nvcc flags (one nvcc per build, all
started together) into ``build/torch_kernels/sass_same``, reads each
library's kernels with ``cuobjdump -sass`` and, per source, holds every
OLD kernel to NEW's: it passes when each OLD kernel's instructions
(addresses and encodings cut) are those of some NEW kernel, whatever
either is named, so a template argument added with a default (the bf16
pass's flag) does not count as a change. Prints per source the kernels
of each build, the OLD kernels without an identical NEW one (a change),
and the NEW kernels without an OLD one (added); exits 1 if any OLD
kernel changed. With ``--fp32`` it holds only the FP32 kernels: the
kernels of the bf16 pass (a name that holds one of ``BF16_MARKS``: the
tensor-core kernels, ``mma`` or ``Mma``; or ``band_times_inverse`` with
its bf16 flag, the last template argument, set, as checkouts before the
bf16 TRSM had a kernel of its own named it), which a change may
redesign, are counted apart and not held.
Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""

from __future__ import annotations

import collections
import glob
import os
import subprocess
import sys

from ..ops.kernels import _build

OUT = os.path.join(_build.BUILD_DIR, "sass_same")
#: name fragments of the bf16 pass's kernels (``--fp32`` does not hold them)
BF16_MARKS = ("mma", "Mma")


def bf16_pass(name: str) -> bool:
    """Whether the (mangled) kernel ``name`` is one of the bf16 pass's."""
    return any(m in name for m in BF16_MARKS) or (
        "band_times_inverse" in name and "Lb1EEEv" in name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fp32 = argv[:1] == ["--fp32"]
    argv = argv[1:] if fp32 else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    old, new, sources = argv[0], argv[1], argv[2:]
    if not sources:
        sources = sorted(os.path.basename(p)
                         for p in glob.glob(os.path.join(new, "*.cu")))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = []
    for tag, d in (("old", old), ("new", new)):
        os.makedirs(os.path.join(OUT, tag), exist_ok=True)
        for src in sources:
            so = os.path.join(OUT, tag, src.replace(".cu", ".so"))
            procs.append((src, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", so, os.path.join(d, src)])))
    for src, p in procs:
        if p.wait() != 0:
            print(f"nvcc failed on {src}")
            return 2
    changed = 0
    for src in sources:
        so = src.replace(".cu", ".so")
        a, b = ({k: tuple(v) for k, v in _build.sass(
            os.path.join(OUT, tag, so)).items()} for tag in ("old", "new"))
        if not a or not b:
            print(f"{src}: no kernels read (is cuobjdump there?)")
            return 2
        if fp32:
            low = sorted(n for n in a if bf16_pass(n))
            a = {n: body for n, body in a.items() if n not in low}
            print(f"{src}: {len(low)} kernels of the bf16 pass not held")
        pool = collections.Counter(b.values())
        lost = []
        for name, body in a.items():
            if pool[body]:
                pool[body] -= 1
            else:
                lost.append(name)
        added = [n for n, body in b.items() if body not in set(a.values())]
        changed += len(lost)
        print(f"{src}: {len(a)} kernels before, {len(b)} after; "
              f"{len(a) - len(lost)} the same instruction for instruction, "
              f"{len(lost)} changed, {len(added)} added", flush=True)
        for n in lost:
            print(f"  changed: {n}")
        for n in added:
            print(f"  added: {n}")
    print("sass_same: " + (f"{changed} kernels changed" if changed
                           else "no kernel changed"))
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
