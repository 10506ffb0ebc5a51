"""The port's C ABI bridge (``utils/cbridge.py``, ``bridge.cpp``,
``superlu_dist_tpu_torch.h``) on the CPU: the Python-side handle
registry against the JAX package's, a compiled C program that solves a
``.rua`` file the test writes, the Fortran module's symbols in the
library and the header, and the refusal to factor without a card unless
the options ask for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from superlu_dist_tpu.utils import cbridge as jcb
from superlu_dist_tpu_torch.utils import cbridge
from superlu_dist_tpu_torch.utils import testing as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = '{"dtype": "float32", "device": "cpu"}'


def _matrix():
    A = sp.random(50, 50, density=0.1, random_state=0,
                  format="csc") + sp.eye(50) * 5.0
    return sp.csc_matrix(A)


def test_python_side_round_trip():
    """The handle registry itself (as the JAX package's test drives it),
    on the CPU, against the JAX package's registry on the same calls."""
    A = _matrix()
    h = cbridge.init(50, A.indptr, A.indices, A.data)
    hj = jcb.init(50, A.indptr, A.indices, A.data)
    assert h > 0 and hj > 0
    assert cbridge.factor(h, CPU) == 0, cbridge.last_error()
    assert jcb.factor(hj, '{"dtype": "float32"}') == 0
    assert cbridge.handle_n(h) == 50
    b = np.empty(50)
    assert cbridge.matvec(h, np.ones(50), b) == 0
    bj = np.empty(50)
    assert jcb.matvec(hj, np.ones(50), bj) == 0
    assert np.array_equal(b, bj)
    buf, bufj = b.copy(), bj.copy()
    assert cbridge.solve(h, buf, 1) == 0
    assert jcb.solve(hj, bufj, 1) == 0
    assert np.abs(buf - 1.0).max() < 1e-5
    assert np.abs(buf - bufj).max() < 1e-12
    sr, si, la = cbridge.logdet(h)
    sj, _, laj = jcb.logdet(hj)
    lu = __import__("scipy.sparse.linalg", fromlist=["splu"]).splu(
        A.astype(np.float64))
    la_ref = float(np.log(np.abs(lu.U.diagonal())).sum())
    assert abs(la - la_ref) < 1e-3
    assert abs(sr - sj) < 1e-12 and si == 0.0 and abs(la - laj) < 1e-4
    cbridge.free(h)
    jcb.free(hj)
    assert cbridge.handle_n(h) == -1


@pytest.mark.parametrize("trans", [0, 1, 2])
def test_python_side_transposed_solves(trans):
    A = sp.csc_matrix(tt.laplacian_3d_unsym(4))
    n = A.shape[0]
    h = cbridge.init(n, A.indptr, A.indices, A.data)
    assert cbridge.factor(h, '{"dtype": "float64", "device": "cpu"}') == 0
    xt = np.linspace(1.0, 2.0, 2 * n)
    op = A if trans == 0 else A.T
    b = np.concatenate([op @ xt[:n], op @ xt[n:]])
    assert cbridge.solve(h, b, 2, trans, 1) == 0
    assert np.abs(b - xt).max() < 1e-10
    cbridge.free(h)


def test_errors_cross_as_codes():
    assert cbridge.solve(10 ** 9, np.zeros(2), 1) == -1
    assert "KeyError" in cbridge.last_error()
    A = _matrix()
    h = cbridge.init(50, A.indptr, A.indices, A.data)
    assert cbridge.solve(h, np.zeros(50), 1) == -1
    assert "factor() must precede solve()" in cbridge.last_error()
    assert cbridge.factor(h, '{"dtype": "float32", "device": "cpu", '
                             '"no_such_option": 1}') == -1
    assert "no_such_option" in cbridge.last_error()
    assert cbridge.read_matrix("/nonexistent/m.rua") == 0
    cbridge.free(h)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_factor_without_a_card_refuses():
    """Without "device" a handle factors on the card; with no card the
    factor returns -1 naming CUDA and never falls back to the CPU."""
    A = _matrix()
    h = cbridge.init(50, A.indptr, A.indices, A.data)
    assert cbridge.factor(h, '{"dtype": "float32"}') == -1
    assert "CUDA" in cbridge.last_error()
    assert cbridge.solve(h, np.ones(50), 1) == -1
    cbridge.free(h)


def _env():
    site = [p for p in sys.path if "site-packages" in p]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + site)
    return env


@pytest.fixture(scope="module")
def consumer(tmp_path_factory):
    d = tmp_path_factory.mktemp("consumer")
    return cbridge.compile_program(cbridge.consumer_source(),
                                   str(d / "bridge_solve"))


def test_c_program_solves_a_written_rua(consumer, tmp_path):
    """A plain C program compiled against the port's header and library
    reads a ``.rua`` the test writes, factors on the CPU, solves with
    refinement, and gets the in-process port's x bit for bit."""
    A = tt.laplacian_3d_unsym(5)
    path = tmp_path / "lap5u.rua"
    tt.write_hb(path, A)
    out = subprocess.run([consumer, str(path), CPU, str(tmp_path / "x.bin")],
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, (out.stdout, out.stderr[-3000:])
    m = re.search(r"CBRIDGE OK n=(\d+) maxerr=(\S+)", out.stdout)
    assert m and int(m.group(1)) == A.shape[0] and float(m.group(2)) < 1e-4
    x = np.fromfile(tmp_path / "x.bin")
    from superlu_dist_tpu_torch import Options, SparseLU
    from superlu_dist_tpu_torch.utils.io import read_matrix
    Ar = read_matrix(path)
    lu = SparseLU(Ar, Options(dtype="float32"), device="cpu")
    b = np.asarray(Ar @ np.ones(Ar.shape[0]))
    xr, _ = lu.refine(b, lu.solve(b))
    assert np.array_equal(x, xr)


def test_c_program_without_a_card_fails(consumer, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    path = tmp_path / "lap3.rua"
    tt.write_hb(path, tt.laplacian_3d(3))
    out = subprocess.run([consumer, str(path)], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 1
    assert "CUDA is not available" in out.stderr
    assert "CBRIDGE OK" not in out.stdout


def _declared_symbols():
    with open(os.path.join(REPO, "bindings", "superlu_tpu_mod.f90")) as f:
        text = f.read()
    syms = re.findall(r'bind\(\s*C\s*,\s*name\s*=\s*"([^"]+)"\s*\)', text,
                      flags=re.IGNORECASE)
    assert syms
    return sorted(set(syms))


def test_f90_symbols_exported_by_the_port_library():
    so = cbridge.build_bridge()
    assert os.path.basename(so).startswith("libsuperlu_dist_tpu_torch-")
    out = subprocess.run(["nm", "-D", "--defined-only", so], check=True,
                         capture_output=True, text=True).stdout
    exported = {line.split()[-1] for line in out.splitlines() if line}
    missing = [s for s in _declared_symbols() if s not in exported]
    assert not missing, missing
    # the same slu_tpu_* set as the JAX package's library
    jso = jcb.build_bridge()
    jout = subprocess.run(["nm", "-D", "--defined-only", jso], check=True,
                          capture_output=True, text=True).stdout
    jexp = {line.split()[-1] for line in jout.splitlines()
            if "slu_tpu_" in line}
    assert {s for s in exported if s.startswith("slu_tpu_")} == jexp


def test_f90_symbols_in_the_port_header():
    with open(cbridge.bridge_header()) as f:
        header = f.read()
    assert os.path.basename(cbridge.bridge_header()) == \
        "superlu_dist_tpu_torch.h"
    missing = [s for s in _declared_symbols() if s not in header]
    assert not missing, missing


def test_bridge_build_failure_raises(tmp_path, monkeypatch):
    """A bridge that does not compile raises with g++'s messages."""
    (tmp_path / "bridge.cpp").write_text("this is not C++\n")
    (tmp_path / "superlu_dist_tpu_torch.h").write_text("\n")
    monkeypatch.setattr(cbridge, "_NATIVE", str(tmp_path))
    with pytest.raises(RuntimeError, match="error"):
        cbridge.build_bridge(cache_dir=str(tmp_path / "cache"))


def test_python_link_reads_sysconfig(monkeypatch):
    import sysconfig
    link = cbridge.python_link()
    assert link["LIBDIR"] == sysconfig.get_config_var("LIBDIR")
    assert link["Py_ENABLE_SHARED"] == 1
    assert f"-lpython{link['LDVERSION']}" in link["flags"]
    get = sysconfig.get_config_var
    monkeypatch.setattr(sysconfig, "get_config_var", lambda k: 0 if
                        k == "Py_ENABLE_SHARED" else get(k))
    with pytest.raises(RuntimeError, match="no shared libpython"):
        cbridge.python_link()
