"""Static schedule counters (the SCT per-level analog).

Device-side spans come from ``Stats.phase`` (``torch.profiler``
``record_function``); this module keeps the plan-derived counters.
"""

from __future__ import annotations

import numpy as np


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
