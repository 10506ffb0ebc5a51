"""Native (C++) host kernels, built on demand with g++ and loaded via
ctypes (the image has no pybind11; the C ABI + ctypes is the bridge, like
the reference's PYTHON/pdbridge ctypes layer)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SRCS = [os.path.join(_DIR, "symbolic.cpp"),
         os.path.join(_DIR, "amd.cpp"),
         os.path.join(_DIR, "mlnd.cpp"),
         os.path.join(_DIR, "hwpm.cpp"),
         os.path.join(_DIR, "tree.cpp")]
_lib = None
_tried = False


def _build() -> str:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    # the build cache lives in the checkout (``build/`` is git-ignored)
    cache = os.path.join(_DIR, *[os.pardir] * 4, "build", "torch_native")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"native-{digest}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", *_SRCS,
             "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("SLU_TPU_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(_build())
    except Exception as e:
        # loud: a silent fallback to the Python planners cost a round-2
        # regression (build break hid behind this except for hours)
        import warnings
        msg = getattr(e, "stderr", b"")
        if isinstance(msg, bytes):
            msg = msg.decode(errors="replace")
        warnings.warn(
            f"superlu_dist_tpu_torch native engine failed to build/load "
            f"({type(e).__name__}); host planning falls back to Python "
            f"(orders of magnitude slower at n>=1e5). Set SLU_TPU_NATIVE=0 "
            f"to silence. First error lines:\n{str(msg)[:800]}")
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.slu_block_symbolic.restype = ctypes.c_void_p
    lib.slu_block_symbolic.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       i64p, i64p]
    lib.slu_sym_size.restype = ctypes.c_int64
    lib.slu_sym_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.slu_sym_copy.restype = None
    lib.slu_sym_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, i64p]
    lib.slu_sym_free.restype = None
    lib.slu_sym_free.argtypes = [ctypes.c_void_p]
    lib.slu_tree_counts.restype = ctypes.c_int64
    lib.slu_tree_counts.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                                    i64p]
    lib.slu_min_degree.restype = ctypes.c_int64
    lib.slu_min_degree.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.slu_nested_dissection.restype = ctypes.c_int64
    lib.slu_nested_dissection.argtypes = [ctypes.c_int64, i64p, i64p,
                                          ctypes.c_int64, ctypes.c_int64,
                                          i64p]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.slu_hwpm.restype = ctypes.c_int64
    lib.slu_hwpm.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                             ctypes.c_int64, i64p]
    _lib = lib
    return _lib


def native_min_degree(indptr: np.ndarray, indices: np.ndarray):
    """C++ approximate minimum degree (quotient graph, supervariables).
    Returns the elimination order or None if the engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    rc = lib.slu_min_degree(
        n, np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int64), perm)
    if rc != 0:
        return None
    return perm


def native_nested_dissection(indptr: np.ndarray, indices: np.ndarray,
                             leaf_size: int = 96, seed: int = 0):
    """C++ multilevel nested dissection (METIS-class; mlnd.cpp).
    Returns the elimination order or None if the engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    rc = lib.slu_nested_dissection(
        n, np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int64),
        leaf_size, seed, perm)
    if rc != 0:
        return None
    return perm


_FIELDS = [
    "diag_slot", "l_ptr", "l_slots", "u_ptr", "u_slots",
    "g_ptr", "g_l", "g_u", "g_t",
    "slot_row", "slot_col", "slot_step", "step_level", "block_parent",
    "lsol_gptr", "lsol_gslot", "lsol_gsrc", "lsol_gdst", "lsol_dptr",
    "lsol_diag",
    "usol_gptr", "usol_gslot", "usol_gsrc", "usol_gdst", "usol_dptr",
    "usol_diag",
]


def native_block_symbolic(nb: int, ab_i: np.ndarray, ab_j: np.ndarray):
    """Run the C++ fill simulation + tape generation. Returns a dict of
    int64 arrays (see _FIELDS), or None if the native library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    ab_i = np.ascontiguousarray(ab_i, dtype=np.int64)
    ab_j = np.ascontiguousarray(ab_j, dtype=np.int64)
    h = lib.slu_block_symbolic(nb, len(ab_i), ab_i, ab_j)
    try:
        out = {}
        for w, name in enumerate(_FIELDS):
            n = lib.slu_sym_size(h, w)
            arr = np.empty(n, dtype=np.int64)
            if n:
                lib.slu_sym_copy(h, w, arr)
            out[name] = arr
        return out
    finally:
        lib.slu_sym_free(h)


def native_hwpm(indptr: np.ndarray, indices: np.ndarray,
                absval: np.ndarray, nthreads: int = 0):
    """Parallel heavy-weight perfect matching (epsilon-scaled auction;
    hwpm.cpp — the d_c2cpp_GetHWPM/CombBLAS analog). Returns rowperm with
    rowperm[j] = matched row of column j, or None if the engine is
    unavailable or no perfect matching was found."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    rc = lib.slu_hwpm(
        n, np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int64),
        np.ascontiguousarray(absval, dtype=np.float64), nthreads, perm)
    if rc != 0:
        return None
    return perm


def native_tree_counts(Lp: np.ndarray, Li: np.ndarray):
    """(parent, colcounts) of the symmetrized pattern whose STRICT LOWER
    CSC triangle is (Lp, Li); None when the native engine is absent."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(Lp) - 1
    parent = np.empty(n, dtype=np.int64)
    cc = np.empty(n, dtype=np.int64)
    rc = lib.slu_tree_counts(n, np.ascontiguousarray(Lp, dtype=np.int64),
                             np.ascontiguousarray(Li, dtype=np.int64),
                             parent, cc)
    if rc != 0:
        return None
    return parent, cc
