"""Fine-grain profiling — the SCT_t / xprof analog.

The reference attributes time to ~80 fine-grain counters inside the
factorization (SCT_t, reference: SRC/include/util_dist.h:198-324). Here:

- **process-wide traces**: set ``SLU_TPU_XPROF=/path/to/dir`` and every
  phase of every solve in the process is captured into one
  ``torch.profiler`` session (CPU activity, and CUDA activity where CUDA
  is present), written to the directory by
  ``torch.profiler.tensorboard_trace_handler`` as a Chrome-trace JSON
  (``*.pt.trace.json``) when :func:`stop_xprof` runs: at interpreter exit
  through ``atexit``, or when called. Each driver phase is a
  ``slu:<PHASE>`` span, and the hand-written kernels' launches appear as
  device-kernel events under their own names. A host that never runs
  ``atexit`` handlers (an embedding program that does not finalize the
  interpreter, as the C bridge does not) calls :func:`stop_xprof` itself.
- **annotations**: :func:`annotate` wraps a phase in a
  ``record_function`` span and, on a CUDA device, an NVTX range
  (``slu_<PHASE>``), the counterpart of the JAX package's
  ``jax.named_scope``; ``Stats.phase`` wraps every phase in it.
- **static schedule counters**: per-level structure histograms recorded
  into ``Stats.counters`` at plan time (``record_schedule_counters``) —
  the static analog of SCT's per-level times, knowable before execution.
"""

from __future__ import annotations

import atexit
import contextlib
import os

import numpy as np

#: the running process-wide profiler (``SLU_TPU_XPROF``), or None
_trace = None


def _maybe_start_xprof():
    """Start a process-wide profiler trace if SLU_TPU_XPROF is set."""
    global _trace
    if _trace is not None:
        return
    logdir = os.environ.get("SLU_TPU_XPROF", "")
    if not logdir:
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _trace = prof
    atexit.register(stop_xprof)


def stop_xprof() -> None:
    """Stop the ``SLU_TPU_XPROF`` trace, if one runs, and write it."""
    global _trace
    prof, _trace = _trace, None
    if prof is not None:
        prof.stop()


@contextlib.contextmanager
def annotate(name: str, cuda: bool):
    """Trace span (``slu:<name>``) and, on a CUDA device, NVTX range
    (``slu_<name>``) for one solver phase.

    ``Stats.phase`` wraps every phase in this automatically, so any
    profile taken of a solve carries the solver phase names with no
    call-site changes. ``cuda`` says whether the phase runs on a CUDA
    device. No-op-cheap when no trace is active.
    """
    import torch
    _maybe_start_xprof()
    with torch.profiler.record_function(f"slu:{name}"):
        if cuda:
            torch.cuda.nvtx.range_push(f"slu_{name}")
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


def record_schedule_counters(stat, plan) -> None:
    """Static per-level schedule histograms (SCT per-level analog).

    Recorded once per plan: number of elimination levels, blocks and GEMM
    jobs per level (min/mean/max), and the critical-path share — the
    fraction of sequential steps that the level-batched executors cannot
    parallelize away.
    """
    step_level = np.asarray(plan.step_level)
    g_ptr = np.asarray(plan.g_ptr)
    nlvl = int(step_level.max()) + 1 if len(step_level) else 0
    steps_per_lvl = np.bincount(step_level, minlength=nlvl)
    gemm_per_step = np.diff(g_ptr)
    gemm_per_lvl = np.zeros(nlvl)
    np.add.at(gemm_per_lvl, step_level, gemm_per_step)
    c = stat.counters
    c["sched_levels"] = nlvl
    c["sched_steps_per_level_max"] = float(steps_per_lvl.max())
    c["sched_steps_per_level_mean"] = float(steps_per_lvl.mean())
    c["sched_gemms_total"] = float(gemm_per_lvl.sum())
    c["sched_gemms_per_level_max"] = float(gemm_per_lvl.max())
    # critical path share: levels with a single step serialize fully
    c["sched_serial_levels"] = float((steps_per_lvl == 1).sum())
