"""Python side of the C ABI bridge (pdbridge parity).

The reference ships a plain-C handle API so non-Python hosts can drive the
solver (reference: PYTHON/pdbridge.h:27-37 — pdbridge_init / factor /
solve / logdet / free). Here the library core is Python/PyTorch, so the C
surface is a thin embedded-CPython shim (``ops/host/native/bridge.cpp``,
public header ``superlu_dist_tpu_torch.h``) that marshals raw pointers
into numpy arrays and calls the handle registry in this module. Its
symbols are the JAX package's ``slu_tpu_*`` ones, so
``bindings/superlu_tpu_mod.f90`` binds either library unchanged.

Build the shared library with :func:`build_bridge`; link a C program
against it::

    so = build_bridge()          # build/torch_native/libsuperlu_dist_tpu_torch-<digest>.so
    hdr = bridge_header()        # .../ops/host/native/superlu_dist_tpu_torch.h
    # g++ prog.c $so -I$(dirname $hdr) -Wl,-rpath,$(dirname $so)

and run it with ``PYTHONPATH`` naming the checkout and the site-packages
that hold torch. A handle factors on the card (``cuda``) unless the
options JSON asks for the CPU with ``"device": "cpu"``; without a card
``slu_tpu_factor`` returns -1 and ``slu_tpu_last_error()`` says so. The
embedded interpreter is never finalized, so nothing here relies on
``atexit``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

import numpy as np

_HANDLES: dict[int, dict] = {}
_NEXT = itertools.count(1)
_LAST_ERROR = ""
_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "ops", "host", "native")


def last_error() -> str:
    return _LAST_ERROR


def _set_error(msg: str) -> None:
    global _LAST_ERROR
    _LAST_ERROR = msg


def init(n: int, colptr, rowind, nzval_re, nzval_im=None) -> int:
    """Register a CSC matrix; returns a positive handle (0 on error)."""
    import scipy.sparse as sp
    try:
        colptr = np.asarray(colptr, dtype=np.int64)
        rowind = np.asarray(rowind, dtype=np.int64)
        vals = np.asarray(nzval_re, dtype=np.float64)
        if nzval_im is not None:
            vals = vals + 1j * np.asarray(nzval_im, dtype=np.float64)
        A = sp.csc_matrix((vals.copy(), rowind.copy(), colptr.copy()),
                          shape=(int(n), int(n)))
        h = next(_NEXT)
        _HANDLES[h] = dict(A=A, lu=None)
        return h
    except Exception as e:          # noqa: BLE001 — crosses the C ABI
        _set_error(f"{type(e).__name__}: {e}")
        return 0


def factor(h: int, options_json: str = "") -> int:
    """Factor the handle's matrix. Returns 0 on success, the singular
    pivot index (info > 0) for singular matrices, -1 on error.

    ``options_json`` holds ``Options`` fields, and optionally
    ``"device"``: the port's ``device=`` keyword (default ``cuda``;
    ``"cpu"`` runs the plain PyTorch versions of the kernels). Without a
    card and without ``"device": "cpu"`` this returns -1: it never falls
    back to the CPU."""
    from ..models.driver import SparseLU
    from .options import Options
    try:
        entry = _HANDLES[int(h)]
        kw = json.loads(options_json) if options_json else {}
        device = kw.pop("device", None)
        if "dtype" not in kw:
            kw["dtype"] = ("complex64" if entry["A"].dtype.kind == "c"
                           else "float32")
        # the previous factors go first, as SparseLU.refactor releases
        # them: a failed factor leaves none
        entry["lu"] = None
        entry["lu"] = SparseLU(entry["A"], Options(**kw), device=device)
        return int(entry["lu"].info)
    except Exception as e:          # noqa: BLE001
        _set_error(f"{type(e).__name__}: {e}")
        return -1


def solve(h: int, b: np.ndarray, nrhs: int, trans: int = 0,
          refine: bool = True) -> int:
    """Solve in place: b (nrhs*n, flattened column-major per RHS) is
    overwritten with x. trans: 0/1/2 = N/T/H. Returns 0 or -1."""
    from .options import Trans
    try:
        entry = _HANDLES[int(h)]
        lu = entry["lu"]
        if lu is None:
            raise RuntimeError("factor() must precede solve()")
        n = lu.n
        B = b[: n * nrhs].reshape(nrhs, n).T
        tr = (Trans.NOTRANS, Trans.TRANS, Trans.CONJ)[int(trans)]
        x = lu.solve(B, trans=tr)
        if refine and tr == Trans.NOTRANS:
            x, _berr = lu.refine(B, x)
        b[: n * nrhs] = np.ascontiguousarray(x.T).reshape(-1)
        return 0
    except Exception as e:          # noqa: BLE001
        _set_error(f"{type(e).__name__}: {e}")
        return -1


def logdet(h: int) -> tuple:
    """(sign_re, sign_im, logabs) of det(A); (0, 0, nan) on error."""
    try:
        lu = _HANDLES[int(h)]["lu"]
        if lu is None:
            raise RuntimeError("factor() must precede logdet()")
        sign, logabs = lu.logdet()
        sign = complex(sign)
        return (float(sign.real), float(sign.imag), float(logabs))
    except Exception as e:          # noqa: BLE001
        _set_error(f"{type(e).__name__}: {e}")
        return (0.0, 0.0, float("nan"))


def read_matrix(path: str) -> int:
    """Load a Harwell-Boeing/Rutherford-Boeing/MatrixMarket file into a
    fresh handle (the dcreate_matrix role for C consumers)."""
    from .io import read_matrix as _read
    try:
        A = _read(path).tocsc()
        h = next(_NEXT)
        _HANDLES[h] = dict(A=A, lu=None)
        return h
    except Exception as e:          # noqa: BLE001
        _set_error(f"{type(e).__name__}: {e}")
        return 0


def handle_n(h: int) -> int:
    try:
        return int(_HANDLES[int(h)]["A"].shape[0])
    except Exception as e:          # noqa: BLE001
        _set_error(f"{type(e).__name__}: {e}")
        return -1


def matvec(h: int, x: np.ndarray, out: np.ndarray) -> int:
    """out = A @ x (for C-side residual checks)."""
    try:
        A = _HANDLES[int(h)]["A"]
        out[: A.shape[0]] = np.asarray(A @ x[: A.shape[1]]).real
        return 0
    except Exception as e:          # noqa: BLE001
        _set_error(f"{type(e).__name__}: {e}")
        return -1


def free(h: int) -> None:
    _HANDLES.pop(int(h), None)


# ---------------------------------------------------------------------------
# building the C shim
# ---------------------------------------------------------------------------


def python_link() -> dict:
    """How the bridge links the interpreter, from ``sysconfig``:
    ``LIBDIR``, ``LDVERSION``, ``Py_ENABLE_SHARED``, and ``flags``, the
    linker arguments: the shared ``libpython`` of ``LIBDIR``, with an
    rpath to it. A Python built without a shared ``libpython`` cannot
    host the bridge, and this raises."""
    import sysconfig
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or \
        f"{sys.version_info.major}.{sys.version_info.minor}"
    shared = int(sysconfig.get_config_var("Py_ENABLE_SHARED") or 0)
    if not shared:
        raise RuntimeError(
            f"this Python ({sys.executable}) has no shared libpython "
            "(Py_ENABLE_SHARED=0): the C bridge links libpython"
            f"{ver}.so from LIBDIR")
    return dict(LIBDIR=libdir, LDVERSION=ver, Py_ENABLE_SHARED=shared,
                flags=[f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                       f"-lpython{ver}"])


def build_bridge(cache_dir: str | None = None) -> str:
    """Compile ``ops/host/native/bridge.cpp`` into
    ``libsuperlu_dist_tpu_torch-<digest>.so`` (embedded CPython) in
    ``build/torch_native/`` of the checkout (or ``cache_dir``), unless it
    is there; returns the .so path. A failed compile or link raises with
    g++'s messages."""
    import hashlib
    import sysconfig
    src = os.path.abspath(os.path.join(_NATIVE, "bridge.cpp"))
    link = python_link()
    h = hashlib.sha256()
    for path in (src, bridge_header()):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(link["flags"]).encode())
    cache = cache_dir or os.path.normpath(os.path.join(
        _NATIVE, *[os.pardir] * 4, "build", "torch_native"))
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache,
                      f"libsuperlu_dist_tpu_torch-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    inc = sysconfig.get_paths()["include"]
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{inc}", src,
           "-o", tmp, *link["flags"]]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"building the C bridge failed ({' '.join(cmd)})"
                           f":\n{done.stderr}")
    os.replace(tmp, so)
    return so


def compile_program(source: str, out: str) -> str:
    """Compile the C (or C++) program ``source`` into the executable
    ``out`` against :func:`bridge_header` and :func:`build_bridge`'s
    library, with an rpath to it and to ``libpython``; returns ``out``.
    A failed compile raises with g++'s messages. ``source`` defaults, in
    the tests and the smoke, to ``ops/host/native/bridge_solve.c``."""
    so = build_bridge()
    link = python_link()
    cmd = ["g++", "-O1", "-x", "c++", source, "-x", "none", so, "-o", out,
           f"-I{os.path.dirname(bridge_header())}",
           f"-Wl,-rpath,{os.path.dirname(so)}", *link["flags"], "-lm"]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"compiling {source} failed ({' '.join(cmd)}):\n"
                           f"{done.stderr}")
    return out


def consumer_source() -> str:
    """Path of ``bridge_solve.c``, the C consumer that reads a matrix
    file, factors, solves with refinement and checks x (its header
    comment says how to run it)."""
    return os.path.abspath(os.path.join(_NATIVE, "bridge_solve.c"))


def bridge_header() -> str:
    """Path of the public C header (``superlu_dist_tpu_torch.h``)."""
    return os.path.abspath(os.path.join(_NATIVE, "superlu_dist_tpu_torch.h"))
