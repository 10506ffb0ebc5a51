"""The PyTorch port stands alone: no module of ``superlu_dist_tpu_torch``
and not ``chip_smoke.py`` imports JAX or the JAX package, and no C++ or
CUDA source of the port names a module of either."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "superlu_dist_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "superlu_dist_tpu")


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


NATIVE = sorted(p for p in (ROOT / "superlu_dist_tpu_torch").rglob("*")
                if p.suffix in (".cpp", ".cu", ".h", ".cuh"))
#: what a C/C++ source would name to reach Python modules of the JAX side
NATIVE_FORBIDDEN = re.compile(
    r"\bsuperlu_dist_tpu\.[A-Za-z_]|\bjax(lib)?\b|PyImport_")


@pytest.mark.parametrize("path", NATIVE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_source_names_no_jax_module(path):
    bad = [m.group(0) for m in NATIVE_FORBIDDEN.finditer(path.read_text())]
    assert not bad, f"{path} names {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys; import superlu_dist_tpu_torch as t; "
            "import superlu_dist_tpu_torch.ops.kernels.clk, "
            "superlu_dist_tpu_torch.ops.kernels.flk, "
            "superlu_dist_tpu_torch.ops.kernels.schur, "
            "superlu_dist_tpu_torch.ops.kernels.solve_gemm, "
            "superlu_dist_tpu_torch.ops.kernels.sweep, "
            "superlu_dist_tpu_torch.ops.kernels.tck, "
            "superlu_dist_tpu_torch.parallel.dist2d, "
            "superlu_dist_tpu_torch.parallel.dist2d_rdma, "
            "superlu_dist_tpu_torch.models.dist_driver; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'superlu_dist_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
