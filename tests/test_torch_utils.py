"""The port's runtime utilities on the CPU: the ``SLU_TPU_XPROF``
process-wide trace and ``annotate`` (``utils/profiling.py``),
``utils/prewarm.py`` (the function and its command line), the env
catalog against the variables the sources read, and the one list of the
port's CUDA kernels."""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from superlu_dist_tpu_torch import Options
from superlu_dist_tpu_torch.ops.kernels import cuda_kernels
from superlu_dist_tpu_torch.ops.kernels._build import CudaKernel
from superlu_dist_tpu_torch.utils import options as topts
from superlu_dist_tpu_torch.utils import profiling
from superlu_dist_tpu_torch.utils import testing as tt
from superlu_dist_tpu_torch.utils.prewarm import prewarm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XPROF_RUN = """
import numpy as np
from superlu_dist_tpu_torch import Options, gssvx
from superlu_dist_tpu_torch.utils.testing import laplacian_3d
A = laplacian_3d(4)
res, lu = gssvx(A, np.ones(A.shape[0]), Options(dtype="float32"),
                device="cpu")
print(res.stat.refine_steps)
"""


def _trace_names(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


def test_xprof_trace_in_a_fresh_process(tmp_path):
    """``SLU_TPU_XPROF`` starts one trace for the process at the first
    phase, written at exit, with every phase as an ``slu:`` span."""
    logdir = tmp_path / "trace"
    env = dict(os.environ, SLU_TPU_XPROF=str(logdir),
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", XPROF_RUN], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = _trace_names(logdir)
    for phase in ("EQUIL", "ROWPERM", "COLPERM", "SYMBFAC", "DIST", "FACT",
                  "SOLVE", "REFINE"):
        assert f"slu:{phase}" in names, phase


def test_xprof_stop_without_atexit(tmp_path, monkeypatch):
    """A host that runs no atexit handlers stops the trace itself."""
    monkeypatch.setenv("SLU_TPU_XPROF", str(tmp_path))
    monkeypatch.setattr(profiling, "_trace", None)
    with profiling.annotate("FACT", cuda=False):
        torch.ones(4).sum()
    assert profiling._trace is not None
    with profiling.annotate("SOLVE", cuda=False):
        pass
    profiling.stop_xprof()
    assert profiling._trace is None
    profiling.stop_xprof()          # idempotent
    names = _trace_names(str(tmp_path))
    assert {"slu:FACT", "slu:SOLVE"} <= names


def test_annotate_without_xprof(monkeypatch):
    monkeypatch.delenv("SLU_TPU_XPROF", raising=False)
    monkeypatch.setattr(profiling, "_trace", None)
    with torch.profiler.profile() as prof:
        with profiling.annotate("FACT", cuda=False):
            torch.ones(4).sum()
    assert profiling._trace is None
    assert "slu:FACT" in {e.name for e in prof.events()}


def test_prewarm_on_the_cpu():
    A = tt.laplacian_3d(6)
    info = prewarm(A, Options(dtype="float32", block_size=16), device="cpu")
    assert set(info) == {"n", "build_s", "factor_s", "solve_s",
                         "escalation_warm_s", "nb", "nslots"}
    assert info["n"] == A.shape[0]
    assert info["factor_s"] > 0 and info["solve_s"] > 0
    # "auto" is "highest" on the CPU: no bf16-first factor, no escalation
    assert info["escalation_warm_s"] == 0
    assert info["nb"] >= A.shape[0] // 16 and info["nslots"] >= info["nb"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_prewarm_needs_a_card_unless_asked():
    with pytest.raises(RuntimeError, match="CUDA"):
        prewarm(tt.laplacian_3d(3))


def test_prewarm_command_line(tmp_path):
    path = tmp_path / "lap5.rua"
    tt.write_hb(path, tt.laplacian_3d(5))
    out = subprocess.run(
        [sys.executable, "-m", "superlu_dist_tpu_torch.utils.prewarm",
         str(path), "--block-size", "16", "--dtype", "float64",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["n"] == 125 and info["escalation_warm_s"] == 0


def test_env_catalog_lists_the_debug_and_trace_variables():
    assert {"CHECKLU", "WRITELU", "XPROF"} <= set(topts._ENV_ONLY)
    assert not {"CHECKLU", "WRITELU", "XPROF"} & set(topts._SPEC_FIELDS)


#: ``SLU_TPU_*`` names that the port reads and that are no solver
#: setting, so ``_ENV_ONLY`` does not list them: the directory of the
#: reference's example matrices, which only ``utils/testing.py`` (test
#: data) reads
ENV_TEST_DATA = {"REFERENCE_EXAMPLES"}
#: a read of one ``SLU_TPU_*`` variable by name: ``os.environ.get``,
#: ``os.environ[...]``, ``os.getenv`` or C's ``getenv``
ENV_READ = re.compile(
    r"""(?:environ\.get\(|environ\[|getenv\()\s*["']SLU_TPU_(\w+)["']""")


def _env_reads():
    """The ``SLU_TPU_*`` names read in the port's sources, by name."""
    pkg = os.path.join(REPO, "superlu_dist_tpu_torch")
    names = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".c", ".cpp", ".h", ".cu", ".cuh")):
                with open(os.path.join(root, f)) as fh:
                    names.update(ENV_READ.findall(fh.read()))
    return names


def test_env_catalog_lists_every_variable_read():
    """``_ENV_ONLY`` is the set of ``SLU_TPU_*`` variables the port reads
    outside ``_SPEC_FIELDS`` (those are read by ``sp_ienv`` and
    ``apply_env_overrides`` through ``_ENV_PREFIX``), less the test data's
    ``ENV_TEST_DATA``. A name only mentioned (``SLU_TPU_CLK_GEMM_PRECISION``
    in ``models/driver.py``, which says the port does not read it) does
    not count."""
    read = _env_reads()
    assert {"NATIVE", "COMPLEX", "SYMB_THREADS"} <= read
    assert "CLK_GEMM_PRECISION" not in read
    assert ENV_TEST_DATA <= read
    assert set(topts._ENV_ONLY) == read - set(topts._SPEC_FIELDS) \
        - ENV_TEST_DATA
    assert not set(topts._ENV_ONLY) & set(topts._SPEC_FIELDS)


def test_one_list_of_kernels():
    ks = cuda_kernels()
    assert all(isinstance(k, CudaKernel) for k in ks.values())
    assert all(name == k.name for name, k in ks.items())
    srcs = {k.source for k in ks.values()}
    csrc = os.path.join(REPO, "superlu_dist_tpu_torch", "ops", "kernels",
                        "csrc")
    assert srcs == {os.path.basename(p)
                    for p in glob.glob(os.path.join(csrc, "*.cu"))}
    assert {"diag_lu", "clk_update_bf16", "clk_trsm_bf16", "sweep",
            "rdma_factor", "schur_batch"} <= set(ks)


def test_stats_phase_keeps_names_and_times():
    from superlu_dist_tpu_torch.utils.stats import Stats
    st = Stats()
    with st.phase("FACT"):
        np.ones(3).sum()
    assert st.utime["FACT"] > 0 and "FACT" in st.report()
