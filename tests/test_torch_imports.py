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
                if p.suffix in (".c", ".cpp", ".cu", ".h", ".cuh"))
#: what a C/C++ source would name to reach Python modules of the JAX side
NATIVE_FORBIDDEN = re.compile(r"\bsuperlu_dist_tpu\.[A-Za-z_]|\bjax(lib)?\b")
#: a call into CPython's import machinery, with its first argument
PY_IMPORT = re.compile(r"\bPyImport_(\w+)\s*\(\s*([^,)]*)")


def _native_names(text: str) -> list:
    """What a C/C++ source names that it must not: the JAX side's
    modules, and any import but ``PyImport_ImportModule`` of a string
    literal that is ``numpy`` or a module of ``superlu_dist_tpu_torch``
    (the C bridge embeds CPython and imports the port's
    ``utils.cbridge``)."""
    bad = [m.group(0) for m in NATIVE_FORBIDDEN.finditer(text)]
    for fn, arg in PY_IMPORT.findall(text):
        lit = re.fullmatch(r'"([^"]*)"', arg.strip())
        name = lit.group(1) if lit else None
        if fn != "ImportModule" or name is None or not (
                name == "numpy" or name.startswith("superlu_dist_tpu_torch.")):
            bad.append(f"PyImport_{fn}({arg.strip()})")
    return bad


@pytest.mark.parametrize("path", NATIVE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_source_names_no_jax_module(path):
    bad = _native_names(path.read_text())
    assert not bad, f"{path} names {bad}"


@pytest.mark.parametrize("text,ok", [
    ('mod = PyImport_ImportModule("superlu_dist_tpu_torch.utils.cbridge");',
     True),
    ('np = PyImport_ImportModule("numpy");', True),
    ('#include "superlu_dist_tpu_torch.h"', True),
    ('mod = PyImport_ImportModule("superlu_dist_tpu.utils.cbridge");', False),
    ('mod = PyImport_ImportModule("jax");', False),
    ('mod = PyImport_ImportModule("scipy");', False),
    ('mod = PyImport_ImportModule(name);', False),
    ('mod = PyImport_Import(name);', False),
    ('#include "superlu_dist_tpu.h"', False),
])
def test_native_check_catches_imports(text, ok):
    """The native check passes the bridge's own imports and catches an
    import of the JAX package's bridge, of any other module, or of a
    name it cannot read."""
    assert (not _native_names(text)) == ok, _native_names(text)


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
            "superlu_dist_tpu_torch.models.dist_driver, "
            "superlu_dist_tpu_torch.utils.io, "
            "superlu_dist_tpu_torch.utils.debug, "
            "superlu_dist_tpu_torch.utils.prewarm, "
            "superlu_dist_tpu_torch.utils.cbridge, "
            "superlu_dist_tpu_torch.utils.profiling; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'superlu_dist_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
