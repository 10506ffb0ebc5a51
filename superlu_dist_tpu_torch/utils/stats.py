"""Runtime statistics — analog of ``SuperLUStat_t`` + ``PStatPrint``.

(reference: SRC/include/util_dist.h:101-135, SRC/prec-independent/util.c:380-480;
fine-grain SCT counters util_dist.h:198-324.)

Phases mirror ``PhaseType`` (superlu_enum_consts.h:66-90). Use::

    stat = Stats()
    with stat.phase("FACT"):
        ...
    stat.ops["FACT"] += flops
    print(stat.report())
"""

from __future__ import annotations

import collections
import contextlib
import time


PHASES = (
    "COLPERM", "ROWPERM", "EQUIL", "ETREE", "SYMBFAC", "DIST",
    "FACT", "COMM", "SOL_COMM", "RCOND", "SOLVE", "REFINE",
)


class Stats:
    """Per-solve phase timers, op counts, and solver counters."""

    def __init__(self):
        self.utime = collections.defaultdict(float)     # seconds per phase
        self.ops = collections.defaultdict(float)       # flops per phase
        self.tiny_pivots = 0          # ReplaceTinyPivot count (pdgstrf2.c)
        self.refine_steps = 0         # RefineSteps (pdgsrfs.c)
        self.peak_buffer_bytes = 0    # peak device pool bytes
        self.counters = collections.defaultdict(float)  # misc (fill ratio, ...)
        self.device = None            # torch.device the timed work runs on
        self.device_ms = collections.defaultdict(float)  # CUDA-event ms

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one phase. The span shows in a ``torch.profiler`` trace as
        ``slu:<name>`` (and as the NVTX range ``slu_<name>`` on a CUDA
        device: ``profiling.annotate``, which also starts the
        ``SLU_TPU_XPROF`` trace). On a CUDA device the phase is also timed
        by CUDA events into ``device_ms``, and the host timer synchronizes
        before it stops, so the phase owns the device work it queued."""
        import torch
        from .profiling import annotate
        cuda = self.device is not None and self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        try:
            with annotate(name, cuda):
                yield self
                if cuda:
                    ev[1].record()
                    torch.cuda.synchronize(self.device)
                    self.device_ms[name] += ev[0].elapsed_time(ev[1])
        finally:
            self.utime[name] += time.perf_counter() - t0

    def report(self) -> str:
        """Analog of ``PStatPrint`` (util.c:380-480)."""
        lines = ["**************************************************",
                 "**** Time (seconds) ****"]
        for ph in PHASES:
            if ph in self.utime:
                line = f"    {ph:<10}: {self.utime[ph]:12.6f}"
                if self.ops.get(ph):
                    mflop = self.ops[ph] / max(self.utime[ph], 1e-12) / 1e6
                    line += f"    Mflops: {mflop:12.2f}"
                lines.append(line)
        total = sum(self.utime.values())
        lines.append(f"    {'TOTAL':<10}: {total:12.6f}")
        lines.append(f"    tiny pivots replaced: {self.tiny_pivots}")
        lines.append(f"    refinement steps:     {self.refine_steps}")
        if self.peak_buffer_bytes:
            lines.append(
                f"    peak device pool:     {self.peak_buffer_bytes/2**20:.2f} MiB")
        for k in sorted(self.counters):
            v = self.counters[k]
            lines.append(f"    {k}: {v:g}" if isinstance(v, (int, float))
                         else f"    {k}: {v}")
        lines.append("**************************************************")
        return "\n".join(lines)
